"""The LLM stack: configs in ``repro_torch.configs``, blocks and ``Model``
here, ``ServeEngine`` in ``repro_torch.serve.engine``."""
