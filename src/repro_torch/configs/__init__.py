"""Architecture definitions: ``base`` (``Cell``, ``ArchDef``), the LM family
(``lm_common``), the recsys family (``recsys_common``), EGNN (``egnn``) and
one module per configuration (``FULL``, ``SMOKE``, ``ARCH``)."""
