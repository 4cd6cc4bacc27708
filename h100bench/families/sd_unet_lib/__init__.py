"""The parts of the ``sd_unet`` family (``families/sd_unet.py``): its plain
reference (``reference``, ``sampling``, ``training``: plain torch and
numpy, nothing of the program under test), its request inputs
(``prompts``), the port's side (``port``) and its counts (``counts``: model
FLOPs and the calls of the port's kernels)."""
