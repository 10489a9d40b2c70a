"""Pair-by-pair parity of the no-GT corridor sequence with the same RANSAC
draws.

The port's and the JAX package's no-GT runs on the 300-frame corridor
(``python -m epivo_tpu_torch.tools.photoreal_ate``,
``python -m tests.reference_accuracy sequence``) draw their RANSAC
samples from different generators, so their pairs are two realizations
of one estimator. This script takes the draws out, in three steps:

1. ``draws`` (CPU, JAX): the reference's ``_extract_pairs`` at ``--seed``
   draws, for every pair of the no-GT run (its key schedule, batches of
   32), Gumbel noise [512 hypotheses, 512 keypoints] and takes each
   hypothesis's 8 largest values over the valid keypoints
   (``ransac._sample_indices``). The draw does not depend on the frames,
   so this step keeps each hypothesis's ``--top`` largest indices in
   order -> ``DIR/draws_seed<s>.npz``;
2. ``extract`` (on the GPU, port only): computes every pair's KLT status
   as the port's step does, takes the first 8 valid indices of each
   hypothesis's list (the reference's sample for that status; a pair with
   a hypothesis whose list holds fewer than 8 valid is marked inexact),
   and runs the port's ``_extract_pairs`` on every pair with those
   samples injected and the ORB retry off -> ``DIR/injected_seed<s>.npz``;
3. ``compare`` (CPU): each pair's pose against the reference run's
   (``tests.reference_accuracy sequence --save-pairs``), the pairs'
   accuracy per kind, and both packages' windowed BA on the port's pairs
   with the reference's result put in for the pairs its ORB retry took;
   ``retry`` (CPU) runs the port's ORB retry pass on those pairs with the
   reference's own draws of its retry pass, so the port's pairs are
   compared with the retry on; ``swap`` (CPU) puts shares of the two
   packages' own runs into each other (the retried pairs, thirds and
   halves of the sequence) to tell where their trajectory gap lies;
   ``probe`` (CPU) measures, on a sample of pairs, how far rounding alone
   moves a pair's pose within each package.

A pair whose KLT status differs between the packages draws other samples
there. The retry pass is left out of step 2: the reference's retry
replaces about ten pairs by ORB, and those pairs are reported apart, or
retried by ``retry``.

    python -m tests.sequence_parity draws --out DIR --seed 0                  # CPU
    PYTHONPATH=. python3 tests/sequence_parity.py extract --out DIR --seed 0  # GPU
    python -m tests.sequence_parity compare --out DIR --seed 0 --reference REF.npz
    python -m tests.sequence_parity retry --out DIR --seed 0 --reference REF.npz
    python -m tests.sequence_parity swap --out DIR --seed 0 --reference REF.npz --port PORT.npz
    python -m tests.sequence_parity probe --out DIR --seed 0 --reference REF.npz

(On a machine whose site-packages hold a ``tests`` package, ``-m tests...``
finds that one; the GPU step imports nothing of this directory.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

BATCH = 32
SAMPLE = 8  # the 8-point minimal sample


def _pairs(n_frames: int) -> list:
    """The pairs the no-GT ``run_ba_sequence`` extracts, in its order."""
    from epivo_tpu_torch.pipeline import runners
    from epivo_tpu_torch.tools import photoreal_ate

    seen = {}

    def record(fs, pairs, *a, **k):
        seen["pairs"] = list(pairs)
        return {}

    extract = runners._extract_pairs
    runners._extract_pairs = record
    try:
        runners.prepare_mono_windows([np.zeros((4, 4), np.float32)] * n_frames,
                                     photoreal_ate.configs()[1], gt_poses=None, device="cpu")
    finally:
        runners._extract_pairs = extract
    return seen["pairs"]


def _batch_keys(seed: int, n_pairs: int, after: int = 0):
    """The reference's RANSAC keys for ``n_pairs`` pairs in batches of
    BATCH (``_extract_pairs``' schedule): one [<= BATCH] key array per
    batch. With ``after``, the keys that follow the batches of ``after``
    pairs (the ORB retry pass follows the KLT pass's batches)."""
    import jax

    from epivo_tpu.pipeline import runners as jrunners

    key = jax.random.PRNGKey(seed)
    for _ in range(0, after, BATCH):
        key, _ = jrunners._split_keys(key, BATCH)
    for c0 in range(0, n_pairs, BATCH):
        key, keys = jrunners._split_keys(key, BATCH)
        yield keys[: min(BATCH, n_pairs - c0)]


def draws(out: str, seed: int, n_frames: int, top: int) -> None:
    import jax

    from tests.reference_accuracy import corridor_ba_config

    pairs = _pairs(n_frames)
    cfg = corridor_ba_config()
    n_hyp, K = cfg.ransac.hypotheses(), cfg.frontend.max_keypoints
    # ransac._sample_indices before its mask: the same draw per key.
    order = jax.jit(jax.vmap(lambda k: jax.lax.top_k(jax.random.gumbel(k, (n_hyp, K)), top)[1]))
    rows = [np.asarray(order(keys)).astype(np.int16) for keys in _batch_keys(seed, len(pairs))]
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, f"draws_seed{seed}.npz"), pair_keys=np.asarray(pairs, np.int64),
             order=np.concatenate(rows))


def _first_valid(order: np.ndarray, status: np.ndarray):
    """Each hypothesis's first SAMPLE indices of ``order`` [H, M] that are
    valid in ``status`` [K]: [H, SAMPLE], and whether every hypothesis
    found SAMPLE of them."""
    ok = status[order]  # [H, M]
    rank = np.argsort(~ok, axis=-1, kind="stable")[:, :SAMPLE]
    return np.take_along_axis(order, rank, -1), bool(ok.sum(-1).min() >= SAMPLE)


def extract(out: str, seed: int, n_frames: int, device: str) -> None:
    import torch

    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.pipeline import runners
    from epivo_tpu_torch.pipeline.config import VOConfig
    from epivo_tpu_torch.tools import photoreal_ate

    z = np.load(os.path.join(out, f"draws_seed{seed}.npz"))
    pairs = [tuple(int(v) for v in p) for p in z["pair_keys"]]
    assert pairs == _pairs(n_frames)
    frames, _, _, _ = photoreal_ate.render_corridor(n_frames)
    ba = photoreal_ate.configs()[1]
    fc = ba.frontend
    table, exact = {}, []
    for c0 in range(0, len(pairs), BATCH):
        chunk = pairs[c0 : c0 + BATCH]
        src = torch.from_numpy(np.stack([frames[i] for i, _ in chunk])).to(device)
        tgt = torch.from_numpy(np.stack([frames[j] for _, j in chunk])).to(device)
        kp = fast.detect(src, fc.fast_threshold, fc.max_keypoints)
        flow = klt.track(src, tgt, kp.xy, valid=kp.valid, win=fc.klt_window,
                         levels=fc.klt_levels, iters=fc.klt_iters, min_eig=fc.klt_min_eig)
        for b, (pr, st) in enumerate(zip(chunk, flow.status.cpu().numpy())):
            smp, ok = _first_valid(z["order"][c0 + b].astype(np.int64), st)
            table[pr] = torch.from_numpy(smp)
            exact.append(ok)
    vo_cfg = VOConfig(camera=ba.camera, frontend=dataclasses.replace(fc, orb_fallback_frac=0.0),
                      ransac=ba.ransac, lm=ba.lm)
    got = runners._extract_pairs(frames, pairs, vo_cfg, seed, n_points=ba.lm.n_points,
                                 batch=BATCH, ransac_samples=table, device=device)
    keys = sorted(got)
    exact_of = dict(zip(pairs, exact))
    np.savez(os.path.join(out, f"injected_seed{seed}.npz"), **runners._pack_pairs(got),
             n_inl=np.asarray([got[k]["n_inl"] for k in keys]),
             rev=np.asarray([got[k]["rev"] for k in keys]),
             exact=np.asarray([exact_of[k] for k in keys]))


def _pose_diff(A, B) -> float:
    """The larger of |R_A - R_B|_F and the difference of the unit
    translation directions of two poses [4, 4]."""
    direction = lambda T: T[:3, 3] / np.linalg.norm(T[:3, 3])
    return float(max(np.linalg.norm(A[:3, :3] - B[:3, :3]),
                     np.linalg.norm(direction(A) - direction(B))))


def compare(out: str, seed: int, reference: str, n_frames: int) -> None:
    from epivo_tpu.pipeline import runners as jrunners
    from epivo_tpu_torch import convert
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.pipeline import runners as trunners
    from epivo_tpu_torch.tools import photoreal_ate
    from tests.reference_accuracy import back_half, corridor_ba_config

    cfg = corridor_ba_config()
    z = np.load(os.path.join(out, f"injected_seed{seed}.npz"))
    port = trunners._unpack_pairs(dict(z))
    keys = sorted(port)
    floor = cfg.frontend.orb_fallback_frac * cfg.frontend.max_keypoints
    retried = {k for q, k in enumerate(keys) if z["rev"][q] or z["n_inl"][q] < floor}
    inexact = {k for q, k in enumerate(keys) if not z["exact"][q]}
    ref = trunners._unpack_pairs(dict(np.load(reference)))
    rows = [(k, _pose_diff(port[k]["T"], ref[k]["T"])) for k in keys]
    off = [r for r in rows if r[1] >= 2e-3]
    _, gt, _ = photoreal.corridor_sequence(n_frames, **photoreal_ate.FIXTURE)  # frames lazy
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    # The port's pairs, with the reference's own result where its retry ran.
    mixed = {k: (ref[k] if k in retried else v) for k, v in port.items()}
    plain = [r for r in off if r[0] not in retried and r[0] not in inexact]
    report = {
        "pairs": len(rows), "inexact": len(inexact), "retried": len(retried),
        "within_2e-3": len(rows) - len(off),
        "off_retried": sum(r[0] in retried for r in off),
        "off_inexact": sum(r[0] in inexact and r[0] not in retried for r in off),
        "off_other": len(plain),
        "off_other_median": float(np.median([r[1] for r in plain])) if plain else 0.0,
        "accuracy_port_injected": photoreal_ate.pair_accuracy(port, gt),
        "accuracy_port_injected_retried_from_reference": photoreal_ate.pair_accuracy(mixed, gt),
        "accuracy_reference": photoreal_ate.pair_accuracy(ref, gt),
    }
    for name, mod, c, kw in (("reference", jrunners, cfg, {}),
                             ("port", trunners, convert.config_from_reference(cfg),
                              {"device": "cpu"})):
        res = back_half(mod, n_frames, c, mixed, **kw)
        report["back_half_" + name] = photoreal_ate.score_no_gt(
            np.asarray(res.trajectory), gt, length)
    print(json.dumps(report))


def retry(out: str, seed: int, reference: str, n_frames: int) -> None:
    """The port's ORB retry pass, on the CPU, over the pairs whose KLT
    result in step 2 calls for it, with the reference's own draws: the
    keys of the reference's retry pass (they follow its KLT batches), each
    pair's sample the first 8 of its draw that the port's ORB matches
    keep (a pair with fewer than 8 matches takes the step's fallback pose,
    whatever its sample). The retried pairs replace the KLT result by the
    runner's rule. Prints how many pairs were retried, had 8 matches and
    were replaced, how many retried
    pairs end within 2e-3 of the reference run's, and both packages'
    windowed BA on the port's pairs: the KLT pass of step 2 with this
    retry, and with the reference's result put in for the retried pairs
    (``compare``'s mix)."""
    import jax
    import torch

    from epivo_tpu_torch import convert
    from epivo_tpu.pipeline import runners as jrunners
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.pipeline import runners as trunners, vo as tvo
    from epivo_tpu_torch.pipeline.config import VOConfig
    from epivo_tpu_torch.tools import photoreal_ate
    from tests.reference_accuracy import back_half, corridor_ba_config

    cfg = corridor_ba_config()
    fc, n_hyp, K = cfg.frontend, cfg.ransac.hypotheses(), cfg.frontend.max_keypoints
    z = np.load(os.path.join(out, f"injected_seed{seed}.npz"))
    port = trunners._unpack_pairs(dict(z))
    keys = sorted(port)
    pairs = _pairs(n_frames)
    order_of = {k: q for q, k in enumerate(keys)}
    floor = fc.orb_fallback_frac * fc.max_keypoints
    rpairs = sorted([k for k in pairs if z["rev"][order_of[k]]
                     or z["n_inl"][order_of[k]] < floor][: fc.orb_fallback_max])
    draw = jax.jit(jax.vmap(lambda k: jax.lax.top_k(jax.random.gumbel(k, (n_hyp, K)), K)[1]))
    order = np.concatenate([np.asarray(draw(ks)) for ks in
                            _batch_keys(seed, len(rpairs), after=len(pairs))])
    frames, _, _, _ = photoreal_ate.render_corridor(n_frames, workers=4)
    # The retry pass sees each frame rounded to uint8.
    frames = [np.clip(np.rint(f), 0, 255).astype(np.uint8).astype(np.float32) for f in frames]
    ba = photoreal_ate.configs()[1]
    vo_cfg = VOConfig(camera=ba.camera, frontend=ba.frontend, ransac=ba.ransac, lm=ba.lm)
    table, matched = {}, 0
    for c0 in range(0, len(rpairs), 8):
        chunk = rpairs[c0 : c0 + 8]
        src, tgt = (torch.from_numpy(np.stack([frames[p[s]] for p in chunk])) for s in (0, 1))
        status = tvo.orb_associate(src, tgt, vo_cfg)[2].numpy()
        for b, pr in enumerate(chunk):
            smp, ok = _first_valid(order[c0 + b].astype(np.int64), status[b])
            table[pr] = torch.from_numpy(smp)
            matched += ok
    orb = trunners._extract_pairs(frames, rpairs, vo_cfg, seed, n_points=ba.lm.n_points,
                                  batch=BATCH, use_orb=True, ransac_samples=table,
                                  device="cpu")
    with_retry = dict(port)
    for k in rpairs:
        e = orb[k]
        if not e["rev"] and e["n_inl"] > int(z["n_inl"][order_of[k]]):
            with_retry[k] = e
    ref = trunners._unpack_pairs(dict(np.load(reference)))
    diffs = [_pose_diff(with_retry[k]["T"], ref[k]["T"]) for k in rpairs]
    _, gt, _ = photoreal.corridor_sequence(n_frames, **photoreal_ate.FIXTURE)  # frames lazy
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    report = {"retried": len(rpairs), "with_8_matches": matched,
              "replaced": sum(with_retry[k] is orb[k] for k in rpairs),
              "retried_within_2e-3_of_reference": int(sum(d < 2e-3 for d in diffs)),
              "retried_median_diff": float(np.median(diffs)),
              "accuracy_retried_port": photoreal_ate.pair_accuracy(
                  {k: with_retry[k] for k in rpairs}, gt)["all"],
              "accuracy_retried_reference": photoreal_ate.pair_accuracy(
                  {k: ref[k] for k in rpairs}, gt)["all"]}
    mixes = {"port_retry": with_retry,
             "reference_retry": {k: (ref[k] if k in rpairs else v) for k, v in port.items()}}
    for mix, data in mixes.items():
        for name, mod, c, kw in (("reference", jrunners, cfg, {}),
                                 ("port", trunners, convert.config_from_reference(cfg),
                                  {"device": "cpu"})):
            res = back_half(mod, n_frames, c, data, **kw)
            report[f"back_half_{name}_{mix}"] = photoreal_ate.score_no_gt(
                np.asarray(res.trajectory), gt, length)
    print(json.dumps(report))


def swap(out: str, seed: int, reference: str, port_run: str, n_frames: int) -> None:
    """Where the trajectory gap between the port's own no-GT run
    (``photoreal_ate --save-pairs``, ``port_run``) and the reference's
    (``reference``) lies: the port's windowed BA (CPU) on either run's
    pairs with a share of them taken from the other run. The shares are
    the pairs step 2's KLT result sends to the ORB retry, and the pairs
    whose first frame lies in each third and each half of the sequence.
    Prints Sim(3) ATE % and length ratio per mix."""
    from epivo_tpu_torch import convert
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.pipeline import runners as trunners
    from epivo_tpu_torch.tools import photoreal_ate
    from tests.reference_accuracy import back_half, corridor_ba_config

    cfg = corridor_ba_config()
    _, gt, _ = photoreal.corridor_sequence(n_frames, **photoreal_ate.FIXTURE)  # frames lazy
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    z = np.load(os.path.join(out, f"injected_seed{seed}.npz"))
    floor = cfg.frontend.orb_fallback_frac * cfg.frontend.max_keypoints
    keys = [tuple(int(v) for v in k) for k in z["pair_keys"]]
    retried = {k for q, k in enumerate(keys) if z["rev"][q] or z["n_inl"][q] < floor}
    port = trunners._unpack_pairs(dict(np.load(port_run)))
    ref = trunners._unpack_pairs(dict(np.load(reference)))

    def score(pairs):
        res = back_half(trunners, n_frames, convert.config_from_reference(cfg), pairs,
                        device="cpu")
        s = photoreal_ate.score_no_gt(np.asarray(res.trajectory), gt, length)
        return [s["ate_sim3_pct_of_length"], s["length_ratio_gauge0"]]

    take = lambda base, other, share: {k: (other[k] if share(k) else v)
                                       for k, v in base.items()}
    report = {"retried": len(retried), "port": score(port), "reference": score(ref),
              "port_with_reference_retried": score(take(port, ref, retried.__contains__)),
              "reference_with_port_retried": score(take(ref, port, retried.__contains__))}
    n = n_frames
    for lo, hi in ((0, n // 3), (n // 3, 2 * n // 3), (2 * n // 3, n), (0, n // 2), (n // 2, n)):
        report[f"reference_with_port_frames_{lo}_{hi}"] = score(
            take(ref, port, lambda k: lo <= min(k) < hi))
    print(json.dumps(report))


def probe(out: str, seed: int, reference: str, n_frames: int, n_pairs: int) -> None:
    """How far float rounding alone moves a pair's pose: for ``n_pairs``
    random pairs that the retry leaves alone, the same pair with the same
    samples through the reference's step jitted for that pair alone, the
    port's step on the CPU, the port on the GPU (step 2) and the
    reference's batched run (``reference``). Prints, for each two of
    them, how many pairs agree within 2e-3 (|R - R'|_F and the
    translation-direction difference) and the median and largest
    difference."""
    import jax
    import jax.numpy as jnp
    import torch

    from epivo_tpu.pipeline import vo as jvo
    from epivo_tpu.pipeline.config import VOConfig as JVOConfig
    from epivo_tpu_torch import convert
    from epivo_tpu_torch.frontend import fast, klt
    from epivo_tpu_torch.pipeline import runners as trunners, vo as tvo
    from epivo_tpu_torch.tools import photoreal_ate
    from tests.reference_accuracy import corridor_ba_config

    cfg = corridor_ba_config()
    fc = cfg.frontend
    vcfg = JVOConfig(camera=cfg.camera, frontend=fc, ransac=cfg.ransac, lm=cfg.lm)
    tcfg = convert.config_from_reference(vcfg)
    z = np.load(os.path.join(out, f"injected_seed{seed}.npz"))
    gpu = trunners._unpack_pairs(dict(z))
    keys = sorted(gpu)
    ref = trunners._unpack_pairs(dict(np.load(reference)))
    d = np.load(os.path.join(out, f"draws_seed{seed}.npz"))
    pairs = [tuple(int(v) for v in p) for p in d["pair_keys"]]
    lane_key = dict(zip(pairs, (k for ks in _batch_keys(seed, len(pairs)) for k in ks)))
    floor = fc.orb_fallback_frac * fc.max_keypoints
    keep = [k for q, k in enumerate(keys) if not (z["rev"][q] or z["n_inl"][q] < floor)]
    pick = [keep[i] for i in np.random.default_rng(1).choice(len(keep), n_pairs, replace=False)]
    frames, _, _, _ = photoreal_ate.render_corridor(n_frames, workers=4)
    step = jax.jit(lambda a, b, k: jvo.vo_step(a, b, k, vcfg))
    rows = []
    for pr in pick:
        a, b = (torch.from_numpy(np.ascontiguousarray(frames[f])) for f in pr)
        kp = fast.detect(a[None], fc.fast_threshold, fc.max_keypoints)
        st = klt.track(a[None], b[None], kp.xy, valid=kp.valid, win=fc.klt_window,
                       levels=fc.klt_levels, iters=fc.klt_iters,
                       min_eig=fc.klt_min_eig).status[0].numpy()
        smp, _ = _first_valid(d["order"][pairs.index(pr)].astype(np.int64), st)
        cpu = tvo.vo_step(a, b, None, tcfg, ransac_samples=torch.from_numpy(smp)).T.numpy()
        one = np.asarray(step(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), lane_key[pr]).T)
        runs = {"reference, one pair": one, "reference, batch": ref[pr]["T"],
                "port, CPU": cpu, "port, GPU": gpu[pr]["T"]}
        rows.append({(x, y): _pose_diff(runs[x], runs[y]) for i, x in enumerate(runs)
                     for y in list(runs)[i + 1:]})
    report = {}
    for pair in rows[0]:
        v = np.array([r[pair] for r in rows])
        report[" vs ".join(pair)] = {"within_2e-3": int((v < 2e-3).sum()), "of": len(v),
                                     "median": float(np.median(v)), "max": float(v.max())}
    print(json.dumps(report))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("command", choices=("draws", "extract", "compare", "retry", "swap",
                                        "probe"))
    ap.add_argument("--out", required=True, help="directory of the step files")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--top", type=int, default=48,
                    help="draws: indices kept per hypothesis, in order")
    ap.add_argument("--device", default="cuda", help="extract: the port's device")
    ap.add_argument("--pairs", type=int, default=48, help="probe: pairs to probe")
    ap.add_argument("--reference", default=None,
                    help="compare, retry, swap, probe: the reference run's pairs "
                    "(reference_accuracy --save-pairs)")
    ap.add_argument("--port", default=None,
                    help="swap: the port's own run's pairs (photoreal_ate --save-pairs)")
    args = ap.parse_args(argv)
    if args.command != "extract":
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.command == "draws":
        draws(args.out, args.seed, args.frames, args.top)
    elif args.command == "extract":
        extract(args.out, args.seed, args.frames, args.device)
    elif args.command == "compare":
        compare(args.out, args.seed, args.reference, args.frames)
    elif args.command == "retry":
        retry(args.out, args.seed, args.reference, args.frames)
    elif args.command == "swap":
        swap(args.out, args.seed, args.reference, args.port, args.frames)
    else:
        probe(args.out, args.seed, args.reference, args.frames, args.pairs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
