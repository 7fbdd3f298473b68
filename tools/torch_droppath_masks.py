"""The drop-path keep masks that the InvPT decoder blocks draw in the first
training step of ``train.make_trainer``'s trainer, for a range of seeds, on
the card: which seeds leave a decoder branch dropped for every sample (its
gradient is then zero, and ``chip_smoke.py``'s checked step refuses such a
seed).

    python tools/torch_droppath_masks.py --seeds 8-19

One line a config and seed: ``masks <config> <seed> <dead branches>
<masks>``; a block's masks are its attention branch's and its MLP
branch's, a bool a sample. The forward runs the plain versions: the masks
come from the trainer's generator alone.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import _DropPathMasks  # noqa: E402
from mtt_tpu_torch.train import CONFIGS, make_trainer  # noqa: E402
from mtt_tpu_torch.utils.train_utils import to_device  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="pascal_invpt_vitl,nyud_invpt_vitl")
    ap.add_argument("--seeds", default="8-19", help="first-last")
    args = ap.parse_args(argv)
    first, last = map(int, args.seeds.split("-"))
    dev = torch.device("cuda")
    for name in args.configs.split(","):
        p = CONFIGS[name]
        for seed in range(first, last + 1):
            trainer, data = make_trainer(p, seed, dev)
            masks = _DropPathMasks(trainer.model)
            x = to_device(data.batch(0, p["trBatch"]), dev)["image"]
            with torch.no_grad(), masks:
                trainer.model(x.to(trainer.dtype), impl="plain", train=True,
                              generator=trainer.generator)
            print(f"masks {name} {seed} {masks.dead()} {masks.masks}",
                  flush=True)
            del trainer, data, x
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
