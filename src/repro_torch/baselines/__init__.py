"""The out-of-core baselines the paper compares GraphMP against (Tables 3
and 5): ``PSWEngine`` (GraphChi's parallel sliding windows) and
``ESGEngine`` (X-Stream's edge-centric scatter-gather).  Their I/O is the
reference package's, file for file and byte for byte; a program's device
callables run on the engine's ``device``."""
from repro_torch.baselines.esg import ESGEngine  # noqa: F401
from repro_torch.baselines.psw import PSWEngine  # noqa: F401

__all__ = ["ESGEngine", "PSWEngine"]
