"""repro_torch — iPDB's semantic SQL engine on PyTorch and CUDA (NVIDIA H100).

A second package beside ``repro`` (the JAX reference).  The first slice runs
one semantic SQL query end to end on the dense KV layout:

    IPDB.sql → TorchExecutor → ContinuousBatcher / InferenceEngine.generate
      → models.model.forward (dense family) → kernels.ops
        (prefill flash attention, dense decode attention, constrained sample)

Ground rules:

* It imports ``torch``, never ``jax``, and nothing of ``repro``.  What it
  needs from ``repro`` it keeps as its own copy: the JAX-free modules
  (relational/, most of core/, serving/{tokenizer,grammar}, models/config,
  the config registry) are verbatim copies with only ``repro.`` changed to
  ``repro_torch.`` in their imports; ``tests/test_torch_isolation.py`` keeps
  them in sync with the originals.
* Its entry points run on CUDA unless the caller passes ``device="cpu"``:
  ``InferenceEngine(..., device=None)`` and ``IPDB(device=None)`` mean
  ``"cuda"`` and raise when no GPU is present.  They never fall back to the
  CPU on their own.
* Every kernel wrapper in ``kernels.ops`` runs its plain PyTorch version
  (``kernels.ref``) only for CPU tensors; for CUDA tensors it launches the
  hand-written Hopper kernel (``kernels/csrc``) or raises.
"""
