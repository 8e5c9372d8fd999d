"""Command-line interface, ported from ``bigkrls_tpu/cli.py``:

    python -m bigkrls_tpu_torch fit data.csv --y-col 0 --out model_dir
    python -m bigkrls_tpu_torch summary model_dir
    python -m bigkrls_tpu_torch predict model_dir newdata.csv --se
    python -m bigkrls_tpu_torch cv data.csv --y-col 0 --kfolds 5 --seed 1234
    python -m bigkrls_tpu_torch reducibility model_dir
    python -m bigkrls_tpu_torch plot model_dir -o effects.png
    python -m bigkrls_tpu_torch explore model_dir -o effects.html
    python -m bigkrls_tpu_torch warmup --shapes 3106x67
    python -m bigkrls_tpu_torch bench

Every subcommand takes ``--device`` (default ``cuda``) and ends its output
with a JSON line that names the device its model ran on. CSVs are numeric
with an optional single header row, parsed by the native reader when it
is built. ``--mesh`` ('all', a device count such as '4', or a 2-D shape
such as '2x4') fits over a mesh of the visible devices of ``--device``'s
type; virtual shards (several shards of one device) are available through
the API only (``parallel/sharded.make_mesh``). ``bench`` runs the port's
benchmark (``bench.py``: root ``bench.py``'s metrics, one JSON record a
line, the primary last; ``BENCH_BUDGET_S`` bounds its wall clock).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_fit_args(p):
    p.add_argument("--y-col", type=int, default=0)
    p.add_argument("--sigma", type=float, default=None)
    p.add_argument("--lambda", dest="lambda_", type=float, default=None)
    p.add_argument("--neig", type=int, default=None)
    p.add_argument("--eigtrunc", type=float, default=None)
    p.add_argument("--no-derivative", action="store_true")
    p.add_argument("--no-vcov", action="store_true",
                   help="skip covariance estimation entirely (requires "
                        "--no-derivative): the reference's "
                        "derivative=FALSE, vcov.est=FALSE fast path, "
                        "yhat only, no SEs")
    p.add_argument("--which-derivatives", type=str, default=None,
                   help="comma-separated 0-based column indices")
    p.add_argument("--acf", action="store_true")
    p.add_argument("--x64", action="store_true",
                   help="float64 parity mode")
    p.add_argument("--noisy", action="store_true")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--streaming", action="store_true",
                   help="kernel-free fit: never build the N x N kernel "
                        "(requires --neig < N; by itself from N = 32768)")
    p.add_argument("--fast-eig-power", choices=["auto", "on", "off"],
                   default="auto",
                   help="TF32 streaming power products (default auto: "
                        "only in the flows whose Rayleigh-Ritz recomputes "
                        "K.B)")
    p.add_argument("--mesh", type=str, default=None, metavar="SHAPE",
                   help="multi-device fit over a mesh of the visible "
                        "devices: 'all', a device count ('4') or a 2-D "
                        "RxC shape ('2x4')")
    _add_device_arg(p)


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device for the fit and the kernels "
                        "(default cuda; cpu runs the plain versions)")


def _visible_devices(device: str):
    """The devices ``--mesh`` builds on: every visible CUDA device for a
    CUDA ``--device``, the one CPU for ``cpu``."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _parse_mesh(spec: str, device: str = "cuda"):
    """The fit's device mesh from the CLI spec ('all', '4', '2x4'), over
    the visible devices of ``device``'s type, with the JAX package's
    messages."""
    from .parallel.sharded import make_mesh
    devices = _visible_devices(device)
    spec = spec.strip().lower()
    if spec == "all":
        return make_mesh(devices=devices)
    if "x" in spec:
        parts = spec.split("x")
        if len(parts) != 2 or not all(p.isdigit() and int(p) > 0
                                      for p in parts):
            raise SystemExit(
                f"--mesh {spec!r}: expected 'all', a device count "
                "('4'), or a 2-D RxC shape ('2x4')")
        shape = (int(parts[0]), int(parts[1]))
        if shape[0] * shape[1] > len(devices):
            raise SystemExit(
                f"--mesh {spec}: needs {shape[0] * shape[1]} devices, "
                f"only {len(devices)} visible")
        return make_mesh(shape=shape,
                         devices=devices[:shape[0] * shape[1]])
    if not spec.isdigit() or int(spec) < 1:
        raise SystemExit(
            f"--mesh {spec!r}: expected 'all', a device count ('4'), "
            "or a 2-D RxC shape ('2x4')")
    if int(spec) > len(devices):
        raise SystemExit(
            f"--mesh {spec}: only {len(devices)} devices visible")
    return make_mesh(devices=devices[:int(spec)])


def _fit_kwargs(args):
    kw = dict(sigma=args.sigma, lambda_=args.lambda_, neig=args.neig,
              eigtrunc=args.eigtrunc, acf=args.acf,
              noisy=args.noisy or None, device=args.device)
    if args.no_derivative:
        kw["derivative"] = False
        # vcov stays on by default (the reference's vcov.est=TRUE)
        kw["vcov_est"] = not args.no_vcov
    elif args.no_vcov:
        raise SystemExit(
            "--no-vcov requires --no-derivative (vcov_est is needed to "
            "get derivatives)")
    if args.which_derivatives:
        kw["which_derivatives"] = [int(i) for i in
                                   args.which_derivatives.split(",")]
    if args.checkpoint_dir:
        kw["checkpoint_dir"] = args.checkpoint_dir
    if args.streaming:
        kw["streaming"] = True
    if args.fast_eig_power != "auto":
        kw["fast_eig_power"] = args.fast_eig_power == "on"
    if getattr(args, "mesh", None):
        kw["mesh"] = _parse_mesh(args.mesh, args.device)
    return kw


def _device_of(model, default: str) -> str:
    """The device of a model's tensors (its kernel or covariance factor)."""
    import torch

    from .parallel.sharded import ShardedTensor
    for t in (model.K, getattr(model.vcov_c_factored, "Q", None)):
        if isinstance(t, (torch.Tensor, ShardedTensor)):
            return str(t.device)
    return default


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bigkrls_tpu_torch",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    pf = sub.add_parser("fit", help="fit a KRLS model from a CSV")
    pf.add_argument("data")
    pf.add_argument("--out", required=True)
    pf.add_argument("--overwrite", action="store_true")
    _add_fit_args(pf)

    ps = sub.add_parser("summary", help="summarize a saved model")
    ps.add_argument("model")
    ps.add_argument("--degrees", default="Neffective",
                    choices=["Neffective", "N", "acf"])
    _add_device_arg(ps)

    pp = sub.add_parser("predict", help="predict from a saved model")
    pp.add_argument("model")
    pp.add_argument("newdata")
    pp.add_argument("--se", action="store_true")
    pp.add_argument("--out", default=None, help="write predictions CSV here")
    _add_device_arg(pp)

    pc = sub.add_parser("cv", help="cross-validate")
    pc.add_argument("data")
    pc.add_argument("--seed", type=int, required=True)
    group = pc.add_mutually_exclusive_group(required=True)
    group.add_argument("--kfolds", type=int, default=None)
    group.add_argument("--ptesting", type=float, default=None)
    pc.add_argument("--out", default=None)
    _add_fit_args(pc)

    pr = sub.add_parser("reducibility", help="AME reducibility test")
    pr.add_argument("model")
    pr.add_argument("--loss", type=int, default=2, choices=[1, 2])
    pr.add_argument("--q", type=float, default=0.05)
    _add_device_arg(pr)

    pl = sub.add_parser("plot", help="plot marginal effects (needs "
                                     "matplotlib)")
    pl.add_argument("model")
    pl.add_argument("-o", "--out", required=True)
    _add_device_arg(pl)

    pe = sub.add_parser(
        "explore",
        help="write the standalone interactive HTML effects explorer "
             "(the shiny.bigKRLS counterpart)")
    pe.add_argument("model")
    pe.add_argument("-o", "--out", required=True)
    pe.add_argument("--max-points", type=int, default=None,
                    help="cap on embedded observations (deterministic "
                         "subsample, stated in the UI)")
    pe.add_argument("--title", type=str, default=None)
    _add_device_arg(pe)

    pb = sub.add_parser("bench", help="the port's benchmark (root "
                                      "bench.py's metrics)")
    pb.add_argument("--election-csv", default=None,
                    help="the election data (y in column 0); default: the "
                         "seeded low-rank design of its shape")
    pb.add_argument("--census-csv", default=None,
                    help="the census replication data (y in column 1, X "
                         "from column 2); default: as --election-csv")
    _add_device_arg(pb)

    pw = sub.add_parser(
        "warmup",
        help="build the CUDA kernel library and run a cold and a warm fit "
             "per shape")
    pw.add_argument("--shapes", required=True,
                    help="comma-separated NxP list, e.g. 3106x67,50000x20")
    pw.add_argument("--binary-cols", type=int, default=1,
                    help="trailing binary columns (runs the "
                         "first-difference path too)")
    pw.add_argument("--neig", type=int, default=None)
    pw.add_argument("--eigtrunc", type=float, default=None)
    pw.add_argument("--streaming", action="store_true",
                    help="warm the kernel-free streaming path instead")
    pw.add_argument("--no-derivative", action="store_true")
    pw.add_argument("--once", action="store_true",
                    help="single run (skip the steady-state re-run)")
    pw.add_argument("--cache-dir", default=None,
                    help="where the kernel library is built")
    pw.add_argument("--x64", action="store_true")
    _add_device_arg(pw)

    args = parser.parse_args(argv)

    if args.cmd == "bench":
        from bigkrls_tpu_torch import bench
        return bench.main(device=args.device, election_csv=args.election_csv,
                          census_csv=args.census_csv)

    import bigkrls_tpu_torch as bt
    from bigkrls_tpu_torch.utils.io import design_from_csv, load_csv

    if getattr(args, "x64", False):
        bt.enable_x64()

    if args.cmd == "fit":
        y, X = design_from_csv(args.data, y_col=args.y_col)
        m = bt.fit(y, X, **_fit_kwargs(args))
        folder = bt.save_model(m, args.out,
                               overwrite_existing=args.overwrite, noisy=True)
        print(json.dumps({"saved": folder, "R2": m.R2,
                          "lambda": m.lambda_,
                          "Neffective": m.neffective,
                          "device": _device_of(m, args.device)}))
        return 0

    if args.cmd == "cv":
        y, X = design_from_csv(args.data, y_col=args.y_col)
        cv = bt.crossvalidate(y, X, seed=args.seed, kfolds=args.kfolds,
                              ptesting=args.ptesting, **_fit_kwargs(args))
        print(bt.summary_cv(cv)["text"])
        rep = {"device": _device_of(cv.trained, args.device)}
        if args.out:
            rep["saved"] = bt.save_model(cv, args.out)
        print(json.dumps(rep))
        return 0

    if args.cmd == "warmup":
        from bigkrls_tpu_torch.warmup import enable_compile_cache, warmup
        cache = enable_compile_cache(args.cache_dir)
        kw = {"device": args.device}
        if args.neig is not None:
            kw["neig"] = args.neig
        if args.eigtrunc is not None:
            kw["eigtrunc"] = args.eigtrunc
        if args.streaming:
            kw["streaming"] = True
        if args.no_derivative:
            kw["derivative"] = False
        for spec in args.shapes.split(","):
            n, p = (int(v) for v in spec.lower().split("x"))
            rep = warmup(n, p, binary_cols=args.binary_cols,
                         repeat=not args.once, **kw)
            rep["cache_dir"] = cache
            print(json.dumps(rep))
        return 0

    # the remaining subcommands read a saved model
    m = bt.load_model(args.model, device=args.device)
    done = {"device": _device_of(m, args.device)}

    if args.cmd == "summary":
        print(bt.summary(m, degrees=args.degrees))
    elif args.cmd == "predict":
        newdata = load_csv(args.newdata)
        pred = bt.predict(m, newdata, se_pred=args.se)
        if args.out:
            cols = [pred.predicted]
            hdr = "predicted"
            if args.se:
                cols.append(pred.se_pred)
                hdr += ",se"
            np.savetxt(args.out, np.column_stack(cols), delimiter=",",
                       header=hdr, comments="")
            done.update(written=args.out, n=len(pred.predicted))
        else:
            for i, v in enumerate(pred.predicted):
                line = f"{v:.6g}"
                if args.se:
                    line += f",{pred.se_pred[i]:.6g}"
                print(line)
    elif args.cmd == "reducibility":
        print(bt.reducibility(m, loss=args.loss, q=args.q))
    elif args.cmd == "plot":
        done["written"] = bt.plot_effects(m, save_to=args.out)
    elif args.cmd == "explore":
        kw = {}
        if args.max_points is not None:
            kw["max_points"] = args.max_points
        if args.title is not None:
            kw["title"] = args.title
        done["written"] = bt.effects_explorer(m, args.out, **kw)
    print(json.dumps(done))
    return 0


if __name__ == "__main__":
    sys.exit(main())
