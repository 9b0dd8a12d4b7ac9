"""Runtime helpers: the straggler watchdog of the serving and training
loops, and the fault-tolerant training loop (``fault_tolerance``)."""
