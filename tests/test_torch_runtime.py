"""Port parity: the native runtime (``epivo_tpu_torch/runtime/``) against
the JAX package's (``epivo_tpu/runtime/``).

- ``loader.cpp`` and ``lm_ref.cpp`` byte-equal to the reference's (the
  port keeps its own copy: it may import nothing of ``epivo_tpu``);
- the library builds into ``build/epivo_tpu_torch/runtime/``, keyed by the
  sources and the libpng route (its flags, the headers' bytes, the linked
  library's path, size and time), and nothing is written beside the
  sources; the wheels' libpng16 libraries are tried newest first; it also
  builds with
  the repo's copy of libpng's public headers (``runtime/libpng/``, libpng
  1.6.39) against each libpng16 that an
  installed wheel bundles, the route on machines with no libpng
  development files, and decodes bit-equal there;
- ``decode_png`` on L and RGB PNGs and ``NativeLoader`` (in order, more
  workers than frames) bit-equal to the reference's, an RGB PNG decoding
  to libpng's BT.709 luma exactly (``chip_smoke.py``'s check), a missing
  file raising ``IOError``; the loader's decoder is "native";
- ``lm_refine_pose`` and ``lm_windowed`` bit-equal to the reference's on
  the cases of ``tests/test_runtime.py``, and ``lm_windowed`` against the
  port's ``optim/lm.solve`` within that file's bounds (:132: each zeta's
  rotation within max(0.1 x its initial error, 5e-3) of the truth, the
  native and LM rotations within 2e-2, r_norm within 50 % or 1e-3).

The module skips where ``tests/test_runtime.py``'s ``built`` fixture does:
where the reference's library cannot be built.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from epivo_tpu import runtime as jrt
from epivo_tpu_torch import runtime as trt
from epivo_tpu_torch.datasets import synthetic as tsynthetic
from epivo_tpu_torch.optim import lm as tlm
from epivo_tpu_torch.pipeline import ba as tba
from tests.test_runtime import make_pngs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    if not jrt.available():
        try:
            jrt.build()
        except Exception as e:
            pytest.skip(f"native build failed: {e}")
    return True


@pytest.mark.parametrize("name", trt.SOURCES)
def test_sources_byte_equal(name):
    with open(os.path.join(os.path.dirname(jrt.__file__), name), "rb") as f:
        ref = f.read()
    assert (trt.SRC_DIR / name).read_bytes() == ref


def test_builds_outside_the_sources(built):
    path = trt.build()
    routes = {trt.library_path(include, link) for _, include, link in trt.libpng_candidates()}
    assert path.parent == trt.BUILD_DIR and path in routes and path.exists()
    assert trt.available() and trt.build_error() is None
    assert sorted(p.name for p in trt.SRC_DIR.iterdir() if p.name != "__pycache__") == [
        "__init__.py", "libpng", "lm_ref.cpp", "loader.cpp"]
    assert sorted(p.name for p in trt.PNG_HEADERS.iterdir()) == [
        "png.h", "pngconf.h", "pnglibconf.h"]


def test_library_name_keys_the_libpng_route(tmp_path):
    lib = tmp_path / "libpng16-0.so.16.39.0"
    lib.write_bytes(b"v1")
    inc = tmp_path / "include"
    inc.mkdir()
    (inc / "png.h").write_text("1.6.39")
    route = (["-I", str(inc)], [str(lib), f"-Wl,-rpath,{tmp_path}"])
    names = [trt.library_path([], ["-lpng"]), trt.library_path(*route)]
    (inc / "png.h").write_text("1.6.40")  # other headers
    names.append(trt.library_path(*route))
    lib.write_bytes(b"v2 upgraded")  # the wheel's libpng replaced in place
    names.append(trt.library_path(*route))
    lib.unlink()  # ... or gone
    names.append(trt.library_path(*route))
    assert len(set(names)) == len(names)
    assert trt.library_path([], ["-lpng"]) == names[0]  # and stable otherwise


def test_bundled_libpng_newest_first():
    versions = [trt.libpng_version(p) for p in trt.bundled_libpng()]
    assert versions == sorted(versions, reverse=True)
    assert all(10600 <= v < 10700 for v in versions), versions  # libpng 1.6


def test_builds_with_bundled_libpng(built, tmp_path, monkeypatch):
    candidates = trt.libpng_candidates()
    assert candidates[0] == ("the system's libpng", [], ["-lpng"])
    bundled = candidates[1:]
    if not bundled:
        pytest.skip("no installed wheel bundles a libpng16 here")
    paths, arrays = make_pngs(tmp_path, n=2, mode="RGB")
    for k, (what, include, link) in enumerate(bundled):
        out = tmp_path / f"lib{k}.so"
        r = trt.compile_library(out, include, link)
        assert r.returncode == 0, (what, r.stdout)
        monkeypatch.setattr(trt, "_lib", trt.bind(ctypes.CDLL(str(out))))
        for p in paths:
            np.testing.assert_array_equal(trt.decode_png(p), jrt.decode_png(p))
        assert len(list(trt.NativeLoader(paths))) == 2


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_decode_png_matches_reference(built, tmp_path, mode):
    paths, arrays = make_pngs(tmp_path, n=2, mode=mode)
    for p, a in zip(paths, arrays):
        out = trt.decode_png(p)
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, jrt.decode_png(p))
        if mode == "L":
            np.testing.assert_array_equal(out, a)


def test_decode_rgb_is_bt709_luma(built, tmp_path):
    """chip_smoke.py's RGB check on the card: an RGB PNG of its own writer
    decodes to libpng's fixed-point BT.709 luma exactly, as the
    reference's decoder does."""
    import chip_smoke

    rgb = np.random.default_rng(3).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    rgb[:5] = rgb[:5, :, :1]  # gray rows too
    path = str(tmp_path / "rgb.png")
    chip_smoke.write_png(path, rgb)
    r, g, b = (rgb[..., c].astype(np.int64) for c in range(3))
    luma = ((6968 * r + 23434 * g + 2366 * b) >> 15).astype(np.float32)
    np.testing.assert_array_equal(trt.decode_png(path), luma)
    np.testing.assert_array_equal(jrt.decode_png(path), luma)


def test_decode_missing_file(built):
    with pytest.raises(IOError):
        trt.decode_png("/nonexistent/nope.png")


@pytest.mark.parametrize("n,workers,capacity", [(6, 3, 3), (2, 8, 16)])
def test_loader_matches_reference(built, tmp_path, n, workers, capacity):
    paths, arrays = make_pngs(tmp_path, n=n)
    loader = trt.NativeLoader(paths, n_workers=workers, capacity=capacity)
    assert loader.decoder == "native"
    frames = list(loader)
    ref = list(jrt.NativeLoader(paths, n_workers=workers, capacity=capacity))
    assert len(frames) == len(ref) == n
    for f, r, a in zip(frames, ref, arrays):
        np.testing.assert_array_equal(f, r)
        np.testing.assert_array_equal(f, a)
    # A second pass streams the same frames again.
    assert all(np.array_equal(f, g) for f, g in zip(frames, loader))


def _pose_case():
    """Exact matches of a random pose and a perturbed start (seeded)."""
    g = torch.Generator().manual_seed(11)
    T_gt = tsynthetic.random_pose(g)
    _, p, p_t = tsynthetic.gen_points(g, 48, T_gt)
    T0 = tsynthetic.perturb_pose(g, T_gt, rot_noise=0.03, t_noise=0.05)
    return T_gt.numpy(), T0.numpy(), p.numpy(), p_t.numpy()


def test_lm_refine_pose_matches_reference(built):
    T_gt, T0, p, p_t = _pose_case()
    T_p, acc_p = trt.lm_refine_pose(T0, p, p_t, max_iters=30, huber_delta=1.0)
    T_r, acc_r = jrt.lm_refine_pose(T0, p, p_t, max_iters=30, huber_delta=1.0)
    np.testing.assert_array_equal(T_p, T_r)
    assert acc_p == acc_r > 0
    assert np.linalg.norm(T_p[:3, :3] - T_gt[:3, :3]) < 5e-3


def _window_case():
    spec = tba.mono_window_spec(ws=3)
    scene = tsynthetic.gen_scene_sequence(torch.Generator().manual_seed(21), N=24,
                                          n_zeta=spec.n_zeta,
                                          reps=[tuple(r) for r in spec.reps],
                                          rot_noise=0.04, t_noise=0.08)
    wreps = np.ones(spec.reps.shape[0])
    pmask = np.ones((spec.reps.shape[0], 24), bool)
    pmask[0, -4:] = False  # the mask path
    return spec, scene, wreps, pmask


def test_lm_windowed_matches_reference_and_lm(built):
    spec, scene, wreps, pmask = _window_case()
    args = (scene.T0s.numpy(), spec.reps, scene.p.numpy(), scene.p_t.numpy())
    kw = dict(wreps=wreps, pmask=pmask, max_iters=30, huber_delta=1.0)
    T_nat, r_norm, acc, iters = trt.lm_windowed(*args, **kw)
    ref = jrt.lm_windowed(*args, **kw)
    np.testing.assert_array_equal(T_nat, ref[0])
    assert (r_norm, acc, iters) == ref[1:] and acc > 0 and iters > 0

    out = tlm.solve(scene.T0s, torch.from_numpy(spec.reps), scene.p, scene.p_t,
                    wreps=torch.from_numpy(wreps).float(), pmask=torch.from_numpy(pmask),
                    max_iters=30, huber_delta=1.0)
    Ts, T0s, T_lm = scene.Ts.numpy(), scene.T0s.numpy(), out.T0s.numpy()
    for z in range(spec.n_zeta):
        init = np.linalg.norm(T0s[z, :3, :3] - Ts[z, :3, :3])
        fin = np.linalg.norm(T_nat[z, :3, :3] - Ts[z, :3, :3])
        assert fin < max(0.1 * init, 5e-3), (z, init, fin)
        assert np.linalg.norm(T_nat[z, :3, :3] - T_lm[z, :3, :3]) < 2e-2
    assert r_norm == pytest.approx(float(out.r_norm), rel=0.5, abs=1e-3)


def test_lm_windowed_rejects_bad_spans(built):
    spec, scene, _, _ = _window_case()
    reps = spec.reps.copy()
    reps[0, 1] = spec.n_zeta  # beyond the last zeta
    with pytest.raises(ValueError):
        trt.lm_windowed(scene.T0s.numpy(), reps, scene.p.numpy(), scene.p_t.numpy())
