"""Architecture definitions: ``base`` (``Cell``, ``ArchDef``), the LM family
(``lm_common``) and one module per LM configuration (``FULL``, ``ARCH``)."""
