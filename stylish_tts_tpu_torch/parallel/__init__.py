"""Data-parallel training over processes: the process group
(``multihost``) and the global-batch reductions (``mesh``)."""
