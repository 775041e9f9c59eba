"""The reference package's four examples, run on the port.

    python -m repro_torch.examples.quickstart [--device cuda|cpu]
    python -m repro_torch.examples.graph_analytics [--scale 17] [--device ...]
    python -m repro_torch.examples.serve_lm [--arch mixtral-8x22b] [--device ...]
    python -m repro_torch.examples.train_tiny_lm [--steps 300] [--device ...]

Each has the reference example's flags, printed lines and checks, plus
``--device``: the GPU unless ``--device cpu`` is given (without a GPU it
raises).  Each ``main(argv=None)`` returns what it ran.
"""
