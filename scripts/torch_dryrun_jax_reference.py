"""JAX's dry-run records of the port's production pairs: the reference that
``chip_smoke.py``'s ``dryrun`` phase prints beside the port's records
(its ``JAX_DRYRUN`` table).

For each pair of ``chip_smoke.DRYRUN_PRODUCTION`` it runs the JAX
package's ``launch/dryrun.py`` ``run_one`` (512 forced host devices, on
the CPU; it never runs on the card) and prints one JSON line: the pair's
name, its argument bytes per rank and its collective bytes per rank by
kind, counted by the JAX package's ``collective_bytes`` on the compiled
HLO with its ``/*index=N*/`` comments taken out (the package's own count
skips tuple-typed collectives that carry one, which is how LEP's
all-to-alls print).

Usage: ``PYTHONPATH=src JAX_PLATFORMS=cpu python3
scripts/torch_dryrun_jax_reference.py`` (about a minute).
"""
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from repro.launch import dryrun  # noqa: E402  (sets XLA_FLAGS first)
from repro.launch import hlo_analysis  # noqa: E402

from chip_smoke import DRYRUN_PRODUCTION  # noqa: E402


def main() -> None:
    count = hlo_analysis.collective_bytes
    seen = {}

    def untupled(text):
        seen["bytes"] = count(re.sub(r"/\*index=\d+\*/", "", text))
        return count(text)

    dryrun.hlo.collective_bytes = untupled
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


if __name__ == "__main__":
    main()
