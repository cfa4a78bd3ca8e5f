"""The plain reference: float32 PyTorch, no kernel and nothing of the
program.  ``<family>.py`` holds a model's loss as a function of a weight
dict and a batch; ``train.py`` runs the first steps of training with
``adamw.py``; ``fp8.py`` is the control's lower-precision product."""
