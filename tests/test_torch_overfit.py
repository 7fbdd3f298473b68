"""The port learns (port of tests/test_overfit.py, the reference's overfit
sanity check): a TaskPrompter-ViT-T at 32x32 trained by the port's
``Trainer`` on one synthetic batch of 4 (semseg with 4 classes and depth,
NYUD's losses) for 150 Adam steps at lr 1e-2 drives the loss below half of
its first value, and its eval-mode semseg predictions reach an mIoU above
0.4 against the labels."""

import torch

from torch_threads import torch_threads  # noqa: F401


def test_overfit_single_batch():
    from mtt_tpu_torch.data.synthetic import SyntheticMT
    from mtt_tpu_torch.evaluation.meters import ConfusionMeter
    from mtt_tpu_torch.models.layers import init_weights
    from mtt_tpu_torch.models.wrappers import TaskPrompterNet
    from mtt_tpu_torch.utils.postprocess import get_output
    from mtt_tpu_torch.utils.train_utils import Trainer, to_device

    tasks = ("semseg", "depth")
    num_out = {"semseg": 4, "depth": 1}
    p = {"train_db_name": "NYUD", "ignore_index": 255,
         "intermediate_supervision": False,
         "loss_kwargs": {"loss_weights": {"semseg": 1.0, "depth": 1.0}},
         "optimizer": "adam", "optimizer_kwargs": {"lr": 1e-2},
         "scheduler": "poly", "max_iter": 2000}
    gen = torch.Generator().manual_seed(0)
    model = TaskPrompterNet(tasks, num_out, (32, 32), "TaskPrompter_vitT",
                            tar_dim=24, final_dim=32, use_ctr=False,
                            drop_path_rate=0.0, device="cpu")
    init_weights(model, gen)
    batch = to_device(SyntheticMT(tasks, num_out, (32, 32)).batch(0, 4),
                      "cpu")
    trainer = Trainer(model, p, tasks, torch.float32, gen)
    l0 = float(trainer.step(batch)["total"])
    for _ in range(150):
        losses = trainer.step(batch)
    l_end = float(losses["total"])
    assert l_end < 0.5 * l0, (l0, l_end)

    with torch.no_grad():
        pred = get_output(model(batch["image"])["semseg"], "semseg")
    m = ConfusionMeter(4)
    assert m.score(m.update(m.init(), pred, batch["semseg"]))["mIoU"] > 0.4
