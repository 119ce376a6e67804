"""The drivers: the trainer (``train``) and the server (``serve``), their
step builders (``steps``), the host mesh (``mesh``) and the process-wide
caches (``caches``).  The dry run is not ported yet (ROADMAP Queue 1)."""
