"""Plain PyTorch references of the benchmark's configurations, one module
a family, named by a configuration file's ``reference`` key, and
``common.py``, what they share.  They import nothing of the program."""
