"""Plain PyTorch references, one module per model family, named by a
configuration file's ``reference`` key.  They import nothing of the port."""
