#!/usr/bin/env python3
"""Phase 13 (a) of ``chip_smoke.py`` from one tree: kimi-k2 at full
width, two layers, its forward timed with no mesh and in the three
expert-parallel modes on (data 2 x model 2) lanes of one card.

    python3 tools/mesh_forward_ab.py TREE

``TREE`` is a checkout (for instance one unpacked by ``git archive``);
its ``chip_smoke.py`` and ``src/`` are the ones imported.  Prints the
phase's own log lines, then one line ``AB {"tree": ..., "ms": {mode:
ms a forward}, "card": ...}``.  Run trees in turn in one card session
(parent, change, change, parent) to compare them on the same card.
Needs a CUDA GPU.
"""
import json
import sys
from pathlib import Path


def main() -> int:
    tree = Path(sys.argv[1]).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    if not torch.cuda.is_available():
        print("mesh_forward_ab: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.gpu_name_and_power()
    result, _ = chip_smoke.mesh_full_width(torch, card,
                                           torch.device("cuda", 0))
    print("AB " + json.dumps({"tree": str(tree), "ms": result["ms"],
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
