"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no CUDA device is present (the
decision is made inside the fixture, never at import). On a GPU machine:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py imports JAX, which the GPU machine
need not have.)

Tolerances: FAST (B1), the fused FAST candidate kernel (score, NMS and
the first top-k stage) and window extraction (B2) bit-exact; LK (B3)
|dq| <= 1e-3 px and |derr| <= 1e-3 + 1e-4 |err|: the kernel samples the
patch bit for bit like the plain version, but sums it in another order.
The level kernel (B2 + B3 fused) is held to the same tolerances on the new
guess and the residual, and to equal ``ok`` except where min_ev / win^2
lies within 1e-4 relative of min_eig (its G sums run in another order).
Both fused kernels also run at B = 8, the batched step's batch. Window
extraction also runs at S = 37, the ORB descriptor's window, for the two
frames of one ORB step and the 16 of a batch of 8 pairs.

The ORB step launches the candidate kernel once and the extraction kernel
once (single scale), and 6 / 2 / 8 times candidate / dense / extraction
on the 8-level pyramid of a 376x1241 frame; ``vo_step_orb_batched`` at
B = 2 on the kernels against the plain path with the same samples: equal
matches, rotation and translation direction within 2e-3.

The batched LM (``lm.solve_batched``, W = 64 windows) on the card against
the same solve on the CPU: rotations within 1e-3, translation directions
within 3e-3, r_norm rtol 0.2 and atol 1e-5, accepted steps within 8 (the
pose and count bounds of the reference's twin test ``test_lm_lanes.py``;
f32 accept/reject decisions part on rounding near the minimum, and the
epipolar energy does not see the translations' scale, so it is not
compared).
"""

import numpy as np
import pytest
import torch

from epivo_tpu_torch.datasets import photoreal
from epivo_tpu_torch.frontend import fast, image, klt
from epivo_tpu_torch.geometry import se3
from epivo_tpu_torch.geometry.camera import Pinhole
from epivo_tpu_torch.optim import lm
from epivo_tpu_torch.pipeline import config, vo

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int_image(shape, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g).float().to(dev)


@pytest.mark.parametrize("shape", [(64, 96), (127, 255), (376, 1241), (3, 200, 300)])
def test_fast_kernel_bit_exact(dev, shape):
    img = _int_image(shape, 0, dev)
    for nms in (False, True):
        ref = fast.fast_score_map(img, 25.0)
        if nms:
            ref = fast.nms3(ref)
        out = fast.fast_score_map_kernel(img, 25.0, nms=nms)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def _smoothed_int_image(shape, seed, dev):
    img = _int_image(shape, seed, dev)
    return torch.round((img + img.roll(1, -2) + img.roll(1, -1)) / 3.0)


@pytest.mark.parametrize("threshold", [20.0, 0.0, -3.0])
@pytest.mark.parametrize("shape", [(376, 1241), (263, 301), (3, 200, 300)])
def test_fast_candidates_kernel_bit_exact(dev, shape, threshold):
    # Integer scores tie often; at threshold 0 and below every interior
    # pixel scores, and below 0 negative and zero scores take part.
    img = _smoothed_int_image(shape, 2, dev)
    for nms in (False, True):
        ref = fast.fast_score_map(img, threshold)
        if nms:
            ref = fast.nms3(ref)
        ref_v, ref_i = fast.block_candidates(ref)
        val, idx = fast.fast_candidates_kernel(img, threshold, nms=nms)
        torch.cuda.synchronize()
        assert torch.equal(val, ref_v) and torch.equal(idx, ref_i)


def _corridor_batch(dev, B=8):
    """B copies of corridor frame 0 at 376x1241, lane b brightened by
    b * 1e-5 (the batched step's input), and frame 1 for each lane."""
    frames, _, _ = photoreal.corridor_sequence(2, H=376, W=1241, seed=0)
    f0, f1 = (torch.from_numpy(np.asarray(f, np.float32)).to(dev) for f in frames)
    eps = torch.arange(B, device=dev, dtype=torch.float32)[:, None, None] * 1e-5
    return (f0 + eps).contiguous(), f1.expand(B, -1, -1).contiguous()


def test_fast_candidates_kernel_at_batch_eight(dev):
    img0, _ = _corridor_batch(dev)
    val, idx = fast.fast_candidates_kernel(img0, 40.0)
    ref_v, ref_i = fast.block_candidates(fast.nms3(fast.fast_score_map(img0, 40.0)))
    torch.cuda.synchronize()
    assert torch.equal(val, ref_v) and torch.equal(idx, ref_i)
    before = fast.CAND_LAUNCHES
    kp = fast.detect(img0, 40.0, 512)
    assert fast.CAND_LAUNCHES == before + 1 and kp.xy.shape == (8, 512, 2)


def test_detect_kernel_matches_plain(dev):
    img = _smoothed_int_image((376, 1241), 3, dev)
    kp_k = fast.detect(img, 20.0, 512)
    kp_p = fast.detect(img, 20.0, 512, use_kernel=False)
    torch.cuda.synchronize()
    for a, b in zip(kp_k, kp_p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,S", [(1, 34), (8, 46), (2, 21), (2, 37), (16, 37)])
def test_extract_kernel_exact(dev, B, S):
    g = torch.Generator().manual_seed(1)
    H, W, K = 188, 621, 512
    img = torch.rand((B, H, W), generator=g).to(dev)
    oy = torch.randint(0, H - S + 1, (B, K), generator=g).to(dev)
    ox = torch.randint(0, W - S + 1, (B, K), generator=g).to(dev)
    out = klt.extract_windows_kernel(img, oy, ox, S)
    torch.cuda.synchronize()
    assert torch.equal(out, klt.extract_windows_plain(img, oy, ox, S))
    # Out-of-range origins clamp to [0, H - S] x [0, W - S] in both.
    oy, ox = oy + torch.randint(-H, H, oy.shape, generator=g).to(dev), ox - W // 2
    out = klt.extract_windows_kernel(img, oy, ox, S)
    torch.cuda.synchronize()
    assert torch.equal(out, klt.extract_windows_plain(img, oy, ox, S))


def _level_inputs(dev, S, level):
    """LK inputs of one pyramid level of the textured fixture."""
    rng = np.random.default_rng(3)
    H, W, K = 240, 320, 512
    img0 = np.cumsum(np.cumsum(rng.normal(size=(H, W)), 0), 1).astype(np.float32)
    img1 = np.roll(np.roll(img0, 3, 1), -2, 0)
    pts = torch.from_numpy(rng.uniform(10, [W - 10, H - 10], size=(K, 2)).astype(
        np.float32)).to(dev)
    s = 2.0 ** level
    src = image.build_pyramid(torch.from_numpy(img0).to(dev), level + 1)[-1]
    tgt = image.build_pyramid(torch.from_numpy(img1).to(dev), level + 1)[-1]
    T, Ix, Iy, c_eff = klt._template(src, pts / s, 21, S)
    tgt_wins, _, q0 = klt._target(tgt, c_eff, 21, S)
    return tgt_wins, T, Ix, Iy, q0


@pytest.mark.parametrize("S,level", [(34, 0), (46, 2)])
def test_lk_kernel_matches_plain(dev, S, level):
    args = _level_inputs(dev, S, level)
    q_k, e_k = klt.lk_iterate_kernel(*args, 21, 12, 0.01)
    q_p, e_p = klt.lk_iterate_plain(*args, 21, 12, 0.01)
    torch.cuda.synchronize()
    assert float((q_k - q_p).abs().max()) <= 1e-3
    assert bool(((e_k - e_p).abs() <= 1e-3 + 1e-4 * e_p.abs()).all())


def _level_case(dev, S, B, seed):
    """Pyramid-level images and keypoints for the level kernel: B textured
    pairs, keypoints inside, on and beyond the border."""
    rng = np.random.default_rng(seed)
    H, W, K = 150, 260, 300
    src, tgt = [], []
    for b in range(B):
        img0 = np.cumsum(np.cumsum(rng.normal(size=(H, W)), 0), 1).astype(np.float32)
        src.append(img0)
        tgt.append(np.roll(np.roll(img0, 2 + b, 1), -1 - b, 0))
    pts = rng.uniform(-5, [W + 5, H + 5], size=(B, K, 2)).astype(np.float32)
    pts[:, :8] = [[0, 0], [W - 1, H - 1], [0.5, 40.5], [W - 0.5, 20], [-3, -3],
                  [W + 2, 70], [31.5, H - 2.5], [100.5, 0.5]]
    guess = pts + rng.uniform(-2, 2, size=pts.shape).astype(np.float32)
    t = lambda a: torch.from_numpy(np.stack(a) if isinstance(a, list) else a).to(dev)
    return t(src), t(tgt), t(pts), t(guess), (S - 22) // 2


@pytest.mark.parametrize("n_chunks", [1, 2])
@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("S", [34, 46])
def test_level_kernel_matches_plain(dev, S, B, n_chunks):
    src, tgt, pts, guess, margin = _level_case(dev, S, B, seed=S + 10 * B + n_chunks)
    args = (src, tgt, pts, guess, 21, margin, 12, 0.01, 1e-4, n_chunks)
    g_k, ok_k, e_k = klt.track_level_kernel(*args)
    g_p, ok_p, e_p = klt.track_level_composed(*args, use_kernel=False)
    torch.cuda.synchronize()
    assert g_k.shape == g_p.shape and ok_k.shape == ok_p.shape == e_p.shape
    assert float((g_k - g_p).abs().max()) <= 1e-3
    assert bool(((e_k - e_p).abs() <= 1e-3 + 1e-4 * e_p.abs()).all())
    # ok may differ only where min_ev / win^2 is within rounding of min_eig.
    _, Ix, Iy, _ = klt._template(src, pts, 21, 21 + 2 * margin + 1, use_kernel=False)
    min_eig = args[8]
    near = (klt._min_eigenvalue(Ix, Iy) / 441 - min_eig).abs() <= 1e-4 * min_eig
    assert bool(((ok_k == ok_p) | near).all())


def _vo_step_launches(dev, H, W):
    """Kernel launches of one vo_step on a small corridor pair: (fast,
    fast_cand, extract, lk, klt_level)."""
    K = np.array([[110.0, 0, W / 2], [0, 110.0, H / 2], [0, 0, 1.0]])
    frames, _, _ = photoreal.corridor_sequence(2, H=H, W=W, K=K, speed=0.45, seed=11)
    f0, f1 = (torch.from_numpy(np.asarray(f)).to(dev) for f in frames)
    cfg = config.VOConfig(
        camera=Pinhole(110.0, 110.0, W / 2, H / 2, W, H),
        frontend=config.FrontendConfig(fast_threshold=12.0, max_keypoints=128,
                                       klt_levels=3),
        ransac=config.RansacConfig(n_hyp=128), lm=config.LMConfig(n_points=16))
    counts = lambda: (fast.KERNEL_LAUNCHES, fast.CAND_LAUNCHES, klt.EXTRACT_LAUNCHES,
                      klt.LK_LAUNCHES, klt.LEVEL_LAUNCHES)
    before = counts()
    res = vo.vo_step(f0, f1, torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(res.T).all())
    return tuple(a - b for a, b in zip(counts(), before))


def test_vo_step_launches_each_kernel(dev):
    # Below the two-stage size (H*W < 65536): the dense FAST kernel.
    assert _vo_step_launches(dev, 96, 128) == (1, 0, 0, 0, 3)


def test_vo_step_two_stage_launches_fused_fast(dev):
    # Above it: the fused candidate kernel, and no dense map.
    assert _vo_step_launches(dev, 256, 320) == (0, 1, 0, 0, 3)


def _lm_windows(W, seed=0, N=32, noise=1e-4):
    """W two-pose windows of the mono BA spec (spans (0,0), (1,1), (0,1)):
    forward-moving poses, landmarks 12-40 deep, matches with pixel-like
    noise, and perturbed initial poses; all made with numpy."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.3, (W, 2, 3)) + [0, 0, 1.0],
                         rng.normal(0, 0.05, (W, 2, 3))], -1)
    Ts = se3.se3_exp(torch.from_numpy(xi.astype(np.float32))).double().numpy()
    reps = np.array([(0, 0), (1, 1), (0, 1)])
    p, p_t = np.empty((W, 3, N, 3)), np.empty((W, 3, N, 3))
    for r, (z0, z1) in enumerate(reps):
        T = Ts[:, z0] if z0 == z1 else Ts[:, z1] @ Ts[:, z0]
        X = np.stack([rng.uniform(-8, 8, (W, N)), rng.uniform(-4, 4, (W, N)),
                      rng.uniform(12, 40, (W, N))], -1)
        Xt = np.einsum("wij,wnj->wni", T[:, :3, :3], X) + T[:, None, :3, 3]
        p[:, r], p_t[:, r] = X / X[..., 2:3], Xt / Xt[..., 2:3]
        p_t[:, r, :, :2] += rng.normal(0, noise, (W, N, 2))
    dxi = np.concatenate([rng.normal(0, 0.08, (W, 2, 3)), rng.normal(0, 0.04, (W, 2, 3))], -1)
    T0s = (torch.from_numpy(Ts.astype(np.float32))
           @ se3.se3_exp(torch.from_numpy(dxi.astype(np.float32))))
    return (T0s, torch.from_numpy(reps), torch.from_numpy(p.astype(np.float32)),
            torch.from_numpy(p_t.astype(np.float32)))


def _rot_dir(T):
    T = T.double()
    t = T[..., :3, 3]
    return T[..., :3, :3], t / torch.linalg.norm(t, dim=-1, keepdim=True)


def test_lm_solve_batched_card_matches_cpu(dev):
    args = _lm_windows(64)
    out_c = lm.solve_batched(*args, huber_delta=1e-5)
    out_g = lm.solve_batched(*(a.to(dev) for a in args), huber_delta=1e-5)
    torch.cuda.synchronize()
    (R_g, d_g), (R_c, d_c) = _rot_dir(out_g.T0s.cpu()), _rot_dir(out_c.T0s)
    assert float((R_g - R_c).abs().max()) <= 1e-3
    assert float((d_g - d_c).abs().max()) <= 3e-3
    r_g, r_c = out_g.r_norm.cpu(), out_c.r_norm
    assert bool(((r_g - r_c).abs() <= 1e-5 + 0.2 * r_c.abs()).all())
    assert int((out_g.n_accepted.cpu() - out_c.n_accepted).abs().max()) <= 8
    assert int(out_c.n_accepted.min()) > 0


def _orb_case(dev, pyramid=False):
    frames, _, _ = photoreal.corridor_sequence(2, H=376, W=1241, seed=0)
    f0, f1 = (torch.from_numpy(np.asarray(f, np.float32)).to(dev) for f in frames)
    cfg = config.VOConfig(
        camera=Pinhole(718.856, 718.856, 620.5, 188.0, 1241, 376),
        frontend=config.FrontendConfig(fast_threshold=40.0, max_keypoints=512,
                                       orb_pyramid=pyramid),
        ransac=config.RansacConfig(n_hyp=512), lm=config.LMConfig(n_points=48))
    return f0, f1, cfg


@pytest.mark.parametrize("pyramid,expect", [(False, (0, 1, 1, 0, 0)), (True, (2, 6, 8, 0, 0))])
def test_vo_step_orb_launches(dev, pyramid, expect):
    f0, f1, cfg = _orb_case(dev, pyramid)
    counts = lambda: (fast.KERNEL_LAUNCHES, fast.CAND_LAUNCHES, klt.EXTRACT_LAUNCHES,
                      klt.LK_LAUNCHES, klt.LEVEL_LAUNCHES)
    before = counts()
    res = vo.vo_step_orb(f0, f1, torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == expect
    assert bool(torch.isfinite(res.T).all()) and int(res.n_tracked) >= 8


def test_vo_step_orb_batched_kernel_matches_plain(dev):
    from epivo_tpu_torch import ransac

    f0, f1, cfg = _orb_case(dev)
    img0 = torch.stack([f0, f1 + 0.5])
    img1 = torch.stack([f1, f0 + 0.5])
    _, _, status = vo.orb_associate(img0, img1, cfg)
    samples = ransac._sample_indices(torch.Generator(device=dev).manual_seed(1),
                                     cfg.ransac.hypotheses(), 512, status, device=dev,
                                     lead=(2,))
    r_k = vo.vo_step_orb_batched(img0, img1, None, cfg, ransac_samples=samples)
    r_p = vo.vo_step_orb_batched(img0, img1, None, cfg, ransac_samples=samples,
                                 use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(r_k.matches_tgt, r_p.matches_tgt)
    assert torch.equal(r_k.n_tracked, r_p.n_tracked) and int(r_k.n_tracked.min()) >= 8
    (R_k, d_k), (R_p, d_p) = _rot_dir(r_k.T.cpu()), _rot_dir(r_p.T.cpu())
    assert float(torch.linalg.norm(R_k - R_p, dim=(-2, -1)).max()) < 2e-3
    assert float(torch.linalg.norm(d_k - d_p, dim=-1).max()) < 2e-3
