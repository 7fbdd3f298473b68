"""Published weights into a port checkpoint (the repository's
tools/convert_checkpoint.py):

    python -m mtt_tpu_torch.convert_checkpoint --config_exp CONFIG.yml \\
        (--npz ViT-L_16.npz | --torch model_best.pth.tar) --out DIR

The config's model is built at its ``TRAIN.SCALE`` with seeded random
weights, as ``main`` builds it (``inference`` builds at ``TEST.SCALE``, the
same size in every database the port knows); ``--npz`` fills its ViT
backbone from a Google ViT npz (the reference's pretraining source; the
rest keeps the seeded values), ``--torch`` every parameter and BatchNorm
statistic from a released reference checkpoint
(``models/convert_torch.py``). The result is written by
``Trainer.save_checkpoint(DIR)`` at step 0, so ``python -m
mtt_tpu_torch.main`` resumes from it when DIR is the experiment's
``checkpoint`` directory (``work_dirs/<version_name>/checkpoint``) and
``python -m mtt_tpu_torch.inference --ckpt_dir DIR`` restores it.

The ``.pth.tar`` is read with ``torch.load(map_location="cpu",
weights_only=True)``, which unpickles tensors and plain containers only. A
file that also pickles other objects (an argparse namespace, say) is refused
unless ``--allow_pickle`` is given, which loads it with
``weights_only=False``, as the JAX package's converter always does: that
runs whatever code the file names, so give it only for a file you trust.

``main(argv, device=None)`` runs on the card unless the caller passes
another device, as the other entry points do. The checkpoint holds the
trainer's random generator, whose state is the device's kind, so a
checkpoint written on the CPU restores on the CPU. Numpy and torch only.
"""

from __future__ import annotations

import argparse
import pickle
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="published weights -> a port "
                                             "checkpoint")
    ap.add_argument("--config_exp", required=True)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--npz", default=None,
                     help="a Google ViT .npz: fills the backbone")
    src.add_argument("--torch", dest="torch_path", default=None,
                     help="a released reference .pth.tar: fills everything")
    ap.add_argument("--out", required=True, help="the checkpoint directory")
    ap.add_argument("--allow_pickle", action="store_true",
                    help="load a .pth.tar that weights_only refuses with "
                         "weights_only=False (runs the file's pickled code)")
    return ap.parse_args(argv)


def load_reference(path: str, allow_pickle: bool = False) -> dict:
    """The state dict of a released ``.pth.tar`` (``reference_state_dict``
    of the file), read with ``weights_only=True`` unless ``allow_pickle``
    lets a file that needs more through."""
    from mtt_tpu_torch.models.convert_torch import reference_state_dict
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        if not allow_pickle:
            raise SystemExit(
                f"{path} pickles more than tensors, so weights_only=True "
                f"refuses it; pass --allow_pickle to load it with "
                f"weights_only=False if you trust the file")
        obj = torch.load(path, map_location="cpu", weights_only=False)
    return reference_state_dict(obj)


def main(argv=None, device=None) -> int:
    args = parse_args(argv)
    from mtt_tpu_torch.config import create_config
    from mtt_tpu_torch.models import convert as C
    from mtt_tpu_torch.models.convert_torch import convert_full_checkpoint
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.taskprompter import TASKPROMPTER_VIT_SPECS
    from mtt_tpu_torch.models.vit import VIT_SPECS
    from mtt_tpu_torch.models.wrappers import build_model, default_device
    from mtt_tpu_torch.utils.train_utils import Trainer

    t0 = time.perf_counter()
    device = default_device(device)
    p = create_config(args.config_exp, {"run_mode": "infer"})
    size = tuple(p.TRAIN.SCALE)
    gen = torch.Generator(device=device).manual_seed(0)
    model = build_model(p, img_size=size, device=device, dtype=torch.float32)
    init_weights(model, gen)
    t_built = time.perf_counter()

    if args.npz:
        spec = {**VIT_SPECS, **TASKPROMPTER_VIT_SPECS}.get(p["backbone"])
        if spec is None:
            raise SystemExit(f"--npz fills a ViT backbone; {p['backbone']} "
                             f"is not one")
        grid = (size[0] // spec["patch_size"], size[1] // spec["patch_size"])
        state = C.load_vit_npz(args.npz, model.state_dict(), spec["depth"],
                               grid, num_heads=spec["num_heads"])
        what = f"the backbone from {args.npz}"
    else:
        sd = load_reference(args.torch_path, args.allow_pickle)
        state = convert_full_checkpoint(sd, model)
        what = f"every key from {args.torch_path} ({len(sd)} keys)"
    t_mapped = time.perf_counter()
    model.load_state_dict(state, strict=True)
    del state
    trainer = Trainer(model, p, p.TASKS.NAMES, torch.float32, gen,
                      log_fn=lambda s: None)
    path = trainer.save_checkpoint(args.out)
    t_end = time.perf_counter()
    print(f"[convert] {p['backbone']} {type(model).__name__}: {what}; "
          f"wrote {path} in {t_end - t0:.1f} s (model built "
          f"{t_built - t0:.1f}, weights read and mapped "
          f"{t_mapped - t_built:.1f}, loaded and saved "
          f"{t_end - t_mapped:.1f})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
