"""JAX's dry-run records of the port's production pairs: the reference that
``chip_smoke.py``'s ``dryrun`` phase prints beside the port's records
(its ``JAX_DRYRUN`` table), and, for one pair, JAX's collective bytes by
site: the counterpart of ``scripts/torch_dryrun_sites.py``.

With no arguments, for each pair of ``chip_smoke.DRYRUN_PRODUCTION`` it
runs the JAX package's ``launch/dryrun.py`` ``run_one`` (512 forced host
devices, on the CPU; it never runs on the card) and prints one JSON line:
the pair's name, its argument bytes per rank and its collective bytes per
rank by kind, counted by the JAX package's ``collective_bytes`` on the
compiled HLO with its ``/*index=N*/`` comments taken out (the package's
own count skips tuple-typed collectives that carry one, which is how LEP's
all-to-alls print).

With ``--arch`` and ``--shape`` it compiles that one pair (at smoke width,
``BATCH`` rows of ``SEQ`` tokens, on a ``--mesh`` of the host devices,
data x model, 2 x 4 by default, with ``--shape`` a kind; or the whole config at a shape of ``INPUT_SHAPES`` on
16 x 16 with ``--production``) and prints each kind's bytes by site: the
innermost frame of each collective's HLO metadata, ``path:line`` under
the package, marked ``(transpose)`` in the backward (``?`` where XLA left
none), counted as ``collective_bytes``
counts (a collective in a scanned layer once per trip), then one JSON line
``{"sites": ..., "totals": ..., "argument_bytes": ...}``.

Usage: ``PYTHONPATH=src JAX_PLATFORMS=cpu python3
scripts/torch_dryrun_jax_reference.py`` (about a minute), or ``... --arch
deepseek-r1 --shape train_4k --production``.
"""
import argparse
import json
import re
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from repro.launch import dryrun  # noqa: E402  (sets XLA_FLAGS first)
from repro.launch import hlo_analysis  # noqa: E402

from chip_smoke import DRYRUN_PRODUCTION  # noqa: E402

#: rows and tokens of a smoke pair, as ``scripts/torch_dryrun_sites.py``
BATCH, SEQ = 8, 64

_OP = re.compile(r"^(\s*%?[\w.\-]+\s*=\s*(?:\([^=]*?\)|[^\s]+)\s+)([\w\-]+)")
_FRAME = re.compile(r"stack_frame_id=(\d+)")


def untupled(text: str) -> str:
    return re.sub(r"/\*index=\d+\*/", "", text)


def frame_sites(text: str):
    """Stack frame id -> ``path:line`` under the package of the HLO
    module's innermost frame there (its ``FileNames``, ``FileLocations`` and
    ``StackFrames`` tables)."""
    def table(name):
        m = re.search(rf"^{name}\n((?:\d+ .*\n?)*)", text, re.M)
        return dict(ln.split(" ", 1) for ln in
                    (m.group(1).splitlines() if m else []))

    files = {k: v.strip('"') for k, v in table("FileNames").items()}
    locs = {k: re.search(r"file_name_id=(\d+) .*?line=(\d+)", v).groups()
            for k, v in table("FileLocations").items()}
    out = {}
    for k, v in table("StackFrames").items():
        f, line = locs[re.search(r"file_location_id=(\d+)", v).group(1)]
        path = files[f]
        path = path[path.rfind("/repro/") + 1:] if "/repro/" in path \
            else path.rsplit("/", 1)[-1]
        out[k] = f"{path}:{line}"
    return out


def _site(line: str, frames) -> str:
    m = _FRAME.search(line)
    site = frames.get(m.group(1), "?") if m else "?"
    return site + (" (transpose)" if "transpose(" in line else "")


def sites_of(text: str):
    """{site: {kind: bytes}} of the HLO ``text``: ``collective_bytes`` of
    the text with every collective of the other sites renamed out of its
    kind, so each site's bytes are counted through the same loops."""
    text = untupled(text)
    frames = frame_sites(text)
    lines = text.splitlines()
    kinds = hlo_analysis.COLLECTIVE_OPS
    marked = []
    for i, line in enumerate(lines):
        m = _OP.match(line)
        if m and any(m.group(2) == k or m.group(2).startswith(k + "-start")
                     for k in kinds):
            marked.append((i, _site(line, frames), m))
    out = defaultdict(dict)
    for site in sorted({s for _, s, _ in marked}):
        masked = list(lines)
        for i, s, m in marked:
            if s != site:
                masked[i] = m.group(1) + "x-" + line_rest(lines[i], m)
        got = hlo_analysis.collective_bytes("\n".join(masked))
        out[site] = {k: got[k] for k in kinds if got[k]}
    return dict(out)


def line_rest(line: str, m) -> str:
    return line[len(m.group(1)):]


def compile_pair(args):
    """(compiled HLO text, argument bytes) of one pair."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import get_config, get_shape, smoke_variant
    from repro.configs.base import InputShape
    from repro.core.parallel import set_current_mesh
    from repro.launch.mesh import make_production_mesh
    from repro.launch.sharding import to_shardings

    if args.production:
        cfg, shape = get_config(args.arch), get_shape(args.shape)
        mesh = make_production_mesh()
    else:
        cfg = smoke_variant(get_config(args.arch))
        shape = InputShape("p", SEQ, BATCH, args.shape)
        data, model = (int(n) for n in args.mesh.split("x"))
        mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(
            data, model), ("data", "model"))
    set_current_mesh(mesh)
    with mesh:
        step, xs, spec = dryrun.build_step(cfg, shape, mesh)
        c = jax.jit(step, in_shardings=to_shardings(mesh, spec)).lower(
            *xs).compile()
    return c.as_text(), int(c.memory_analysis().argument_size_in_bytes)


def one_pair(args) -> None:
    text, arg_b = compile_pair(args)
    sites = sites_of(text)
    totals = hlo_analysis.collective_bytes(untupled(text))
    kinds = hlo_analysis.COLLECTIVE_OPS
    print(f"{'site':44s} " + " ".join(f"{k:>18s}" for k in kinds))
    for site, by in sorted(sites.items(), key=lambda kv: -sum(kv[1].values())):
        print(f"{site:44s} " + " ".join(f"{by.get(k, 0):18,d}"
                                         for k in kinds))
    print(f"{'total':44s} " + " ".join(f"{totals[k]:18,d}" for k in kinds))
    print(json.dumps({"sites": sites, "totals": totals,
                      "argument_bytes": arg_b}))


def production() -> None:
    count = hlo_analysis.collective_bytes
    seen = {}

    def counted(text):
        seen["bytes"] = count(untupled(text))
        return count(text)

    dryrun.hlo.collective_bytes = counted
    for arch, shape, multi_pod in DRYRUN_PRODUCTION:
        rec = dryrun.run_one(arch, shape, multi_pod=multi_pod, save=False,
                             verbose=False)
        mesh = "2x16x16" if multi_pod else "16x16"
        if rec["status"] != "ok":
            raise SystemExit(f"{arch} × {shape} × {mesh}: {rec.get('error')}")
        coll = {k: v for k, v in seen["bytes"].items() if k != "count"}
        print(json.dumps({"pair": f"{arch} × {shape} × {mesh}",
                          "argument_bytes": rec["argument_bytes"],
                          "collectives": coll}, ensure_ascii=False),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--mesh", default="2x4")
    args = ap.parse_args()
    if args.arch or args.shape:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape together")
        one_pair(args)
    else:
        production()


if __name__ == "__main__":
    main()
