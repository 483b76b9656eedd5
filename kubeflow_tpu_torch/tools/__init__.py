"""Native developer tools of the port, built on first use (``mpi.py``)."""
