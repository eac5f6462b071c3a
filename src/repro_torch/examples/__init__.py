"""The reference's three demos on the port (mirrors ``examples/``): each
has ``main(argv=None, *, device="cuda", ...)`` and runs as
``python -m repro_torch.examples.<name> [--device cpu]``.

* ``quickstart`` — train, checkpoint, restore into a fresh LM, step on;
* ``train_e2e``  — a ~100M-parameter LM with periodic checkpoints and a
                   simulated failure and restart;
* ``serve_batch`` — continuous batching with a mid-flight engine
                   migration.
"""
