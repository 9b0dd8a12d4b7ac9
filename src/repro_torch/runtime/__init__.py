"""Runtime helpers of the serving loop (the straggler watchdog)."""
