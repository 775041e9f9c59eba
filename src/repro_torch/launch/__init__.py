"""Command-line entry points of the LLM stack (``python -m
repro_torch.launch.serve`` and ``python -m repro_torch.launch.train``)."""
