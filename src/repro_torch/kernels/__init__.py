"""SpDISTAL leaf kernels (and the LM stack's attention kernel) for Hopper.

Per kernel family: ``<name>.py`` (the wrapper around a CUDA kernel under
``csrc/``, with its plain PyTorch version and launch counter), ``ops.py``
(single-shard wrappers, ``impl="torch"|"cuda"``), ``ref.py`` (the plain
PyTorch leaves and dense oracles), ``layout.py`` (the dense operands
packed into the blocks of a blocked operand's grid) and ``autotune.py``
(the plan-time tile tuner the autoscheduler reads). ``_build.py``
compiles and loads the CUDA sources on first use.
"""
