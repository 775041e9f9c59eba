"""``python -m repro_torch.obs FILE...`` — validate metrics JSONL files."""
from repro_torch.obs.metrics import main

raise SystemExit(main())
