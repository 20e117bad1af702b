#!/usr/bin/env python3
"""How far rounding moves the disparity segmentation (ROADMAP F8).

Runs ``pde_tpu``'s ``disp_segmentation`` on the maps and reduced loop counts
of ``tests/test_torch_segmentation.py`` (dense, sparse, warm start) and
compares, by mean and max |dphi|, the share of equal SEG pixels and SParam:

* ``pde_tpu`` jitted against the same code run op by op (``jax.disable_jit``);
* ``pde_tpu`` against itself with every ``jnp.exp`` one ulp lower;
* ``pde_tpu`` against itself with its bicubic resize's sums taken in the
  reverse order (the same products; the zero-diffusivity freeze of the AOS
  step, ``|grad phi| == 0``, turns one ulp of a flat +-5 region into O(1));
* ``pde_tpu_torch`` with the JAX-backed draw stream against ``pde_tpu``;
* ``pde_tpu_torch`` against itself with its likelihood's exp one ulp lower.

Then, in the chained runs of both packages (the port on the JAX stream),
every live stage that turns an input difference under 0.01 into an output
difference over 0.1: how many input pixels differ and by how much, at how
many pixels the zero-diffusivity freeze (``|grad phi| == 0``) of the two
inputs disagrees, and ``pde_tpu``'s stage run on the port's input against
the port's output.

Then, stage by stage on ``pde_tpu``'s own inputs, what the stage tests of
``tests/test_torch_segmentation.py`` measure: the port's stage (with
``pde_tpu``'s exp and log) against ``pde_tpu``'s, beside ``pde_tpu``'s stage
with its input phi moved by one ulp at a tenth of the pixels. It prints the
largest max |dphi| and the largest mean |dphi| over the live stages.

Each run is a child process, so that a patched function is traced into no
other run. CPU only; about 20 minutes, most of it the op-by-op runs
(``--runs`` without ``op_by_op`` leaves them out):

    JAX_PLATFORMS=cpu python3 scripts/seg_rounding.py [--variants dense sparse warm] [--runs ...]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
RUNS = ("jit", "op_by_op", "jit_exp_down", "jit_resize_reversed", "port", "port_exp_down")
PAIRS = (("jit", "op_by_op", "pde_tpu jitted vs op by op"),
         ("jit", "jit_exp_down", "pde_tpu vs its exp one ulp lower"),
         ("jit", "jit_resize_reversed", "pde_tpu vs its resize's sums reversed"),
         ("jit", "port", "pde_tpu_torch (JAX stream) vs pde_tpu"),
         ("port", "port_exp_down", "pde_tpu_torch vs its exp one ulp lower"))


def reverse_resize_sums(jseg, jres) -> None:
    """``pde_tpu``'s ``imresize`` with both contractions summed from the
    last tap to the first: the same products, another rounding."""
    import jax
    import jax.numpy as jnp

    def imresize(x, out_size, method="bilinear"):
        out_h, out_w = out_size
        h, w = x.shape[-2:]
        kernel = "cubic" if method == "bicubic" else "triangle"
        r = jnp.asarray(jres.resize_matrix(h, out_h, True, kernel))[:, ::-1]
        c = jnp.asarray(jres.resize_matrix(w, out_w, True, kernel))[:, ::-1]
        hp = jax.lax.Precision.HIGHEST
        y = jnp.einsum("oh,...hw->...ow", r, x.astype(jnp.float32)[..., ::-1, :], precision=hp)
        return jnp.einsum("pw,...ow->...op", c, y[..., ::-1], precision=hp)

    jseg.imresize = jres.imresize = imresize


def recorded(mod, kinds, calls, mp, host):
    """Patch ``mod``'s stage functions ``kinds`` to append (kind, inputs,
    static arguments, outputs) to ``calls``, each value passed through
    ``host``."""
    for kind in kinds:
        real = getattr(mod, kind)

        def run(*args, _real=real, _kind=kind, **static):
            out = _real(*args, **static)
            calls.append((_kind, [host(a) for a in args], static, [host(o) for o in out]))
            return out

        mp.setattr(mod, kind, run)


def amplifying_stages(variant: str) -> None:
    """The live stages of the chained runs that turn an input difference
    under 0.01 into an output difference over 0.1, and what their inputs
    show."""
    import jax
    import jax.numpy as jnp
    import pytest
    import torch

    torch.set_num_threads(1)
    import pde_tpu.models.segmentation as jseg
    import pde_tpu_torch.models.segmentation as tseg
    from test_torch_segmentation import JaxDraws, _case

    din, entry, kw = _case(variant)
    kinds = ("_seed_stage", "_rc_stage")
    ours, theirs = [], []

    def host(x):
        x = x.key if isinstance(x, JaxDraws) else x
        return x.numpy() if torch.is_tensor(x) else np.asarray(x)

    with pytest.MonkeyPatch.context() as mp:
        recorded(jseg, kinds, theirs, mp, host)
        recorded(tseg, kinds, ours, mp, host)
        getattr(jseg, entry)(din, **kw)
        getattr(tseg, entry)(din, _draws=JaxDraws(jax.random.PRNGKey(0)), device="cpu", **kw)
    found = False
    for i, ((kind, args, static, out), (_, t_args, _, t_out)) in enumerate(zip(theirs, ours)):
        live = kind == "_rc_stage" or not bool(out[4])
        phi, t_phi = args[1], t_args[1]
        d_out = np.abs(t_out[0] - out[1])
        if not live or d_out.max() <= 0.1 or np.abs(phi - t_phi).max() >= 0.01:
            continue
        found = True
        frozen = np.asarray(jseg._grad_mag(jnp.asarray(phi))) == 0.0
        t_frozen = np.asarray(jseg._grad_mag(jnp.asarray(t_phi))) == 0.0
        moved = list(args)
        moved[1] = t_phi
        again = np.asarray(getattr(jseg, kind)(*[jnp.asarray(a) for a in moved], **static)[1])
        print(f"{variant:6s} amplified: stage {i} ({kind}, {tuple(phi.shape)}): port vs "
              f"pde_tpu max |dphi| {d_out.max():.3g}, mean {d_out.mean():.3g}; inputs differ at "
              f"{int((phi != t_phi).sum())} of {phi.size} pixels, max {np.abs(phi - t_phi).max():.3g}; "
              f"|grad phi| == 0 at {int(frozen.sum())} (pde_tpu) and {int(t_frozen.sum())} (port) "
              f"pixels, disagreeing at {int((frozen != t_frozen).sum())}; pde_tpu's stage on the "
              f"port's input vs the port's output: max |dphi| "
              f"{np.abs(again - t_out[0]).max():.3g}", flush=True)
    if not found:
        print(f"{variant:6s} no live stage turns an input difference under 0.01 into one over "
              f"0.1", flush=True)


def stage_readings(variant: str) -> None:
    """The stage tests' comparison over every live stage of one variant."""
    import jax
    import jax.numpy as jnp
    import pytest
    import torch

    torch.set_num_threads(1)
    import pde_tpu.models.segmentation as jseg
    import pde_tpu_torch.models.segmentation as tseg
    from test_torch_segmentation import JaxDraws, _case, _reference_exp_log

    din, entry, kw = _case(variant)
    calls = []
    real = {k: getattr(jseg, k) for k in ("_seed_stage", "_rc_stage")}
    with pytest.MonkeyPatch.context() as mp:
        recorded(jseg, real, calls, mp, np.asarray)
        getattr(jseg, entry)(din, **kw)
    rng = np.random.default_rng(1)
    worst = {}
    with pytest.MonkeyPatch.context() as mp:
        _reference_exp_log(mp)
        for kind, args, static, out in calls:
            if kind == "_seed_stage":
                if bool(out[4]):
                    continue  # a dead seed's phi is discarded
                key, *fields, gamma, rcons, tau = args
                t = [torch.from_numpy(np.array(x)) for x in fields]
                got = tseg._seed_stage(JaxDraws(jnp.asarray(key)), *t, float(gamma),
                                       [float(r) for r in rcons], float(tau), **static)[0]
            else:
                key, *fields, cset, tau, gamma, thr = args
                t = [torch.from_numpy(np.array(x)) for x in fields]
                got = tseg._rc_stage(JaxDraws(jnp.asarray(key)), *t, float(cset), float(tau),
                                     float(gamma), float(thr), **static)[0]
            want = out[1]
            phi = args[1]
            sel = rng.random(phi.shape) < 0.1
            to = np.where(rng.random(phi.shape) < 0.5, np.inf, -np.inf).astype(np.float32)
            moved = list(args)
            moved[1] = np.where(sel, np.nextafter(phi, to), phi).astype(np.float32)
            ulp = np.asarray(real[kind](*[jnp.asarray(a) for a in moved], **static)[1])
            for what, x in (("port", got.numpy()), ("pde_tpu, input one ulp", ulp)):
                d = np.abs(x - want)
                mx, mn = worst.get((kind, what), (0.0, 0.0))
                worst[(kind, what)] = (max(mx, float(d.max())), max(mn, float(d.mean())))
    for (kind, what), (mx, mn) in worst.items():
        print(f"{variant:6s} {kind:11s} {what} vs pde_tpu: max |dphi| {mx:.3g}, largest mean "
              f"|dphi| {mn:.3g}", flush=True)


def child(run: str, variant: str, out: str) -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    if run == "stages":
        stage_readings(variant)
        return
    if run == "chain":
        amplifying_stages(variant)
        return
    import jax
    import jax.numpy as jnp

    if run == "jit_exp_down":
        exp = jnp.exp
        jnp.exp = lambda x: jnp.nextafter(exp(x), jnp.zeros_like(exp(x)))
    from test_torch_segmentation import JaxDraws, _case

    din, entry, kw = _case(variant)
    if run.startswith("port"):
        import torch

        torch.set_num_threads(1)
        import pde_tpu_torch.models.segmentation as tseg

        if run == "port_exp_down":
            lik = tseg._likelihood

            def lower(dist, cov):
                norm, p = lik(dist, cov)
                return norm, torch.nextafter(p, torch.zeros_like(p))

            tseg._likelihood = lower
        res = getattr(tseg, entry)(din, _draws=JaxDraws(jax.random.PRNGKey(0)), device="cpu",
                                   **kw)
        res = [x.numpy() for x in res]
    else:
        import pde_tpu.core.resize as jres
        import pde_tpu.models.segmentation as jseg

        if run == "jit_resize_reversed":
            reverse_resize_sums(jseg, jres)
        if run == "op_by_op":
            with jax.disable_jit():
                res = getattr(jseg, entry)(din, **kw)
        else:
            res = getattr(jseg, entry)(din, **kw)
        res = [np.asarray(x) for x in res]
    np.savez(out, phi=res[0], seg=res[1], sparam=res[2])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=["dense", "sparse", "warm"])
    ap.add_argument("--runs", nargs="+", default=list(RUNS), choices=RUNS,
                    help="the whole-pipeline runs to make (pairs need both of theirs)")
    ap.add_argument("--child", nargs=3, metavar=("RUN", "VARIANT", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(*args.child)
        return
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        for variant in args.variants:
            res = {}
            for run in args.runs:
                out = os.path.join(tmp, f"{variant}_{run}.npz")
                subprocess.run([sys.executable, __file__, "--child", run, variant, out],
                               check=True, env=env)
                res[run] = np.load(out)
            for a, b, what in PAIRS:
                if a not in res or b not in res:
                    continue
                x, y = res[a], res[b]
                if x["phi"].shape != y["phi"].shape:
                    print(f"{variant:6s} {what}: {x['phi'].shape[0]} vs {y['phi'].shape[0]} "
                          f"segments", flush=True)
                    continue
                d = np.abs(x["phi"] - y["phi"])
                sp = np.abs(x["sparam"] - y["sparam"]).max() / np.abs(x["sparam"]).max()
                print(f"{variant:6s} {what}: mean |dphi| {d.mean():.3g}, max {d.max():.3g}, "
                      f"SEG equal {(x['seg'] == y['seg']).mean():.4%}, SParam {sp:.3g}",
                      flush=True)
            for run in ("chain", "stages"):
                subprocess.run([sys.executable, __file__, "--child", run, variant, "-"],
                               check=True, env=env)


if __name__ == "__main__":
    main()
