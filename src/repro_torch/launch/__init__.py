"""The drivers: the serving loop (``serve``), its step builders (``steps``)
and the process-wide caches (``caches``).  Training and the dry run are not
ported yet (ROADMAP Queue 1 items 2-4)."""
