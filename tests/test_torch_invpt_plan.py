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
    (4, 320, 72, "2 heads"), (2, 321, 72, "at most 320"),
    (2, 0, 72, "at most 320"), (2, 320, 68, "multiple of 8"),
    (2, 320, 488, "up to 480")])
def test_kernel_refuses_shapes_it_does_not_reach(H, Lk, D, match):
    """The limits raise before any launch, on tensors that never reach the
    card; the plain version takes them all."""
    with pytest.raises(ValueError, match=match):
        check_invpt_attention_shape(H, Lk, D)
    q = torch.zeros(1, H, 3, D, dtype=torch.bfloat16)
    k = torch.zeros(1, H, max(Lk, 1), D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match if Lk else "at most 320"):
        invpt_attention_cuda(q, k if Lk else k[:, :, :0], k if Lk else
                             k[:, :, :0], None, None, None, 1.0)
