"""Plain PyTorch references of the benchmark's models and optimizer.

Float32 with TF32 off, one sequence at a time, every product, mask and
rotation written out here.  They import nothing of the program: a
configuration's file names its reference module, and the harness hands
both sides the same weights and inputs, made from the seed.
"""
