"""The plain reference that decides ``correct``: float32 PyTorch, TF32
off, no kernel, cache or batching of the program.

It imports neither JAX nor the JAX package nor anything of
``distkeras_tpu_torch``, and takes nothing the program made: it draws the
weights and inputs again from the seed (``portbench.weights``,
``portbench.traffic``) and reads the program's outputs only to judge them.
``products`` sets the precision of every matrix product, so the same code
serves as the lower-precision control.
"""
