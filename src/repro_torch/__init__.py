"""PyTorch/CUDA port of the ``repro`` model substrate, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and never imports ``jax``. Layout mirrors ``repro``:

* ``configs``  — own copy of the config dataclasses and the arch registry,
* ``kernels``  — hand-written CUDA kernels (``csrc/``), their wrappers and
                 plain PyTorch versions,
* ``models``   — the decoder LM (attention, sliding-window attention,
                 Mamba-2 and RG-LRU layers) as an ``nn.Module``, with its
                 loss,
* ``optim``    — AdamW and the train step,
* ``serving``  — the continuous-batching ``ServingEngine``,
* ``bridge``   — load a JAX parameter tree or AdamW state (as numpy) into
                 the port.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
"""
