"""The parts of the ``svd`` family (``families/svd.py``): its plain reference
(``reference``, ``sampling``: plain torch and numpy, nothing of the program
under test), the port's side (``port``) and its counts (``counts``: model
FLOPs of a clip and the calls of the port's kernels)."""
