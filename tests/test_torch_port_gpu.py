"""pcdet_tpu_torch kernels on the card: kernel vs its plain version.

Marked `gpu`; each test skips without a CUDA device (the kernels have no
CPU mode).  On a machine with a card, run without the JAX suite's conftest
(this file imports only torch and the port):

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerance 1e-5 absolute on the areas; the kernel is built with --fmad=false
and is expected to be bitwise equal to the plain version.
"""
import numpy as np
import pytest
import torch

from pcdet_tpu_torch.ops import nms, rotated_iou, rotated_overlap

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _boxes5(rng, shape, spread=20.0):
    cx = rng.uniform(-spread, spread, shape)
    cy = rng.uniform(-spread, spread, shape)
    w = rng.uniform(0.5, 5.0, shape)
    l = rng.uniform(0.5, 7.0, shape)
    ang = rng.uniform(-np.pi, np.pi, shape)
    return np.stack([cx - w / 2, cy - l / 2, cx + w / 2, cy + l / 2, ang],
                    axis=-1).astype(np.float32)


@pytest.mark.parametrize('g,m,n', [(2, 64, 4096), (3, 37, 1000), (1, 5, 7)])
def test_kernel_matches_plain(cuda, g, m, n):
    rng = np.random.RandomState(0)
    cb = rotated_iou.boxes5_to_corners(
        torch.as_tensor(_boxes5(rng, (g, n)), device=cuda)).contiguous()
    ca = cb[:, :m].contiguous()
    before = rotated_overlap.LAUNCHES
    got = rotated_overlap.pair_overlap_batched(ca, cb)
    assert rotated_overlap.LAUNCHES == before + 1
    want = rotated_overlap.pair_overlap_batched_plain(ca, cb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_kernel_rejects_non_contiguous(cuda):
    c = torch.zeros(2, 8, 4, 2, device=cuda)
    with pytest.raises(ValueError):
        rotated_overlap.pair_overlap_batched(c[:, ::2], c)


@pytest.mark.parametrize('rotated', [True, False])
def test_nms_gpu_matches_cpu(cuda, rotated):
    rng = np.random.RandomState(1)
    g, a = 3, 2000
    boxes = torch.as_tensor(np.stack([_boxes5(rng, a, 15.0)
                                      for _ in range(g)]))
    scores = torch.as_tensor(rng.randn(g, a).astype(np.float32))
    valid = torch.as_tensor(rng.rand(g, a) > 0.1)
    want = nms.nms_bev_batched(boxes, scores, 0.1, pre_max=1024,
                               post_max=300, valid_mask=valid,
                               rotated=rotated)
    got = nms.nms_bev_batched(boxes.to(cuda), scores.to(cuda), 0.1,
                              pre_max=1024, post_max=300,
                              valid_mask=valid.to(cuda), rotated=rotated)
    for w, x in zip(want, got):
        torch.testing.assert_close(x.cpu(), w, rtol=0, atol=0)
