"""The port's versions of ``examples/``: the same file names and flags, on
``sfast_tpu_torch`` and the card.  A directory named ``torch`` on
``sys.path`` would shadow PyTorch, hence this name."""
