"""Native host code of the port: the libjpeg decode+resize pool
(``loader.cc`` and its ctypes wrapper ``loader.py``)."""
