"""The shape limits of the InvPT attention kernel (kernels/invpt_attention.py),
on the CPU: they raise before any launch, on tensors that never reach a card.
The launch plan is the kernel's own (csrc/invpt_attention.cu) and is tested
on the card (tests/test_torch_cuda.py).
"""

import pytest
import torch

from mtt_tpu_torch.kernels.invpt_attention import (
    check_invpt_attention_shape, invpt_attention_cuda)

from torch_threads import torch_threads  # noqa: F401


@pytest.mark.parametrize("H,Lk,D,match", [
    (4, 320, 72, "2 heads"), (2, 65537, 72, "from 1 to 65536"),
    (2, 0, 72, "from 1 to 65536"), (2, 320, 0, "head dim from 1"),
    (2, 320, 1032, "up to 1024")])
def test_kernel_refuses_shapes_it_does_not_reach(H, Lk, D, match):
    """The limits raise before any launch, on tensors that never reach the
    card; the plain version takes them all. Past the resident kernel's 320
    keys and head dim 480 the streamed form takes the shape, so the limits
    are the streamed form's: 65536 keys, head dim 1024 (a head dim that is
    not a multiple of 8 runs zero-padded to one)."""
    with pytest.raises(ValueError, match=match):
        check_invpt_attention_shape(H, Lk, D)
    q = torch.zeros(1, H, 3, D, dtype=torch.bfloat16)
    k = torch.zeros(1, H, max(Lk, 1), D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match if Lk else "from 1 to 65536"):
        invpt_attention_cuda(q, k if Lk else k[:, :, :0], k if Lk else
                             k[:, :, :0], None, None, None, 1.0)


@pytest.mark.parametrize("Lk,D", [
    (1024, 288), (1024, 144), (1024, 72), (1024, 544), (338, 72),
    (321, 72), (320, 488), (320, 544), (272, 272), (65536, 8), (320, 332),
    (320, 166), (320, 83)])
def test_kernel_takes_the_shapes_models_reach(Lk, D):
    """The shapes that were past the kernel's former limits (320 keys, head
    dim 480) and that InvPT reaches from a YAML: Cityscapes-3D's 1024 keys
    at its three stage head dims, embed_dim 1024's 544 and 272, embed_dim
    600's 332, 166 and 83 (zero-padded to 336, 168 and 88), the
    smallest square grid past 320 keys (2 x 13 x 13 = 338), and the edges of
    the new limits. The check passes; the kernel path on a CPU tensor still
    raises before any launch."""
    from mtt_tpu_torch.kernels.invpt_attention import invpt_fused_attention
    check_invpt_attention_shape(2, Lk, D)
    q = torch.zeros(1, 2, 3, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 4, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        invpt_fused_attention(q, k, k, None, None, None, 1.0, impl="cuda")
