"""repro_torch — iPDB's semantic SQL engine on PyTorch and CUDA (NVIDIA H100).

A second package beside ``repro`` (the JAX reference).  It runs a semantic
SQL query end to end for the dense, MoE, SSM (Mamba) and hybrid model
families, on either KV layout where the reference allows it (the paged
layout needs attention and no sliding window); the VLM and encoder
families are not ported yet:

    IPDB.sql → TorchExecutor → ContinuousBatcher / InferenceEngine.generate
      → models.model.forward (dense, MoE, ssm or hybrid family) → kernels.ops
        dense layout: prefill flash attention, dense decode attention
        paged layout (page pool, radix prefix tree, copy-on-write forks,
          int8 frozen pages): prefill flash attention with or without a
          shared prefix read from the pool, paged decode attention over fp
          or int8 pages
        MoE family (models.moe): the grouped matmul of the expert FFNs
        SSM and hybrid families (models.mamba): the selective scan of the
          Mamba mixers, its state carried per row
        every family: constrained sampling

Ground rules:

* It imports ``torch``, never ``jax``, and nothing of ``repro``.  What it
  needs from ``repro`` it keeps as its own copy: the JAX-free modules
  (relational/, most of core/, serving/{tokenizer,grammar,radix},
  models/config, the config registry) are verbatim copies with only ``repro.`` changed to
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
