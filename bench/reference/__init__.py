"""Plain PyTorch references of the benchmark's configurations, one module
a family, named by a configuration file's ``reference`` key.  They import
nothing of the program."""
