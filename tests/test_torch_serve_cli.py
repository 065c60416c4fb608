"""The port's serve CLI (``python -m repro_torch.launch.serve``) against the
JAX package's (``python -m repro.launch.serve``): the same flags with the
same defaults plus ``--device``, and -- given the same weights -- the same
printed lines, on the CPU.
"""
import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import mtp as j_mtp
from repro.launch import serve as j_serve
from repro.models import init_params as j_init_params
from repro_torch.convert import mtp_from_jax_numpy, params_from_jax_numpy
from repro_torch.launch import serve as t_serve

REPO = Path(__file__).resolve().parent.parent


class _Parsed(Exception):
    pass


def _namespace(monkeypatch, run):
    """The parsed arguments of one CLI call, stopping before it builds
    anything."""
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed) as exc:
        run()
    monkeypatch.undo()
    return vars(exc.value.args[0])


def _jax_main(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + list(argv))
    return j_serve.main()


def test_flags_and_defaults_equal_jax_plus_device(monkeypatch, capsys):
    j_ns = _namespace(monkeypatch,
                      lambda: _jax_main(monkeypatch, ["--arch", "x"]))
    t_ns = _namespace(monkeypatch, lambda: t_serve.main(["--arch", "x"]))
    assert t_ns.pop("device") == "cuda"
    assert t_ns == j_ns

    def flags(run):
        with pytest.raises(SystemExit):
            run()
        return set(re.findall(r"--[a-z0-9-]+", capsys.readouterr().out))

    j_flags = flags(lambda: _jax_main(monkeypatch, ["--help"]))
    t_flags = flags(lambda: t_serve.main(["--help"]))
    assert t_flags == j_flags | {"--device"}
    assert len(j_flags) > 40


def test_unported_arch_names_its_slice(capsys):
    """No arch is left unported: Zamba2 serves, HuBERT fails as the JAX
    CLI does (no tokens to embed for an encoder over audio frames), and an
    unknown arch raises ``KeyError``."""
    with pytest.raises(KeyError, match="frames"):
        t_serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    t_serve.main(["--arch", "zamba2-1.2b", "--device", "cpu",
                  "--n-requests", "2", "--max-new", "2"])
    assert "SLO summary (virtual clock): completed=2" in \
        capsys.readouterr().out
    with pytest.raises(KeyError):
        t_serve.main(["--arch", "no-such-arch", "--device", "cpu"])


def _jax_cfg(cfg):
    """The JAX package's config of the port config ``cfg``."""
    from repro.configs import get_config, smoke_variant
    return smoke_variant(get_config(cfg.name.replace("-smoke", "")))


def _lines(text):
    """Printed lines without the wall-clock line (host timing)."""
    return [ln for ln in text.splitlines() if " wall (" not in ln]


def test_cli_prints_jax_lines_on_shared_weights(monkeypatch, capsys):
    """With the JAX CLI's weights and draft head carried across, the port's
    CLI prints the JAX CLI's lines (per-rid lines, SLO summary, decode pool,
    EMS tier stats, transfer, ``--trace`` JSON), the wall-clock line aside:
    fused MTP with the EMS cache on, a two-engine cache-affinity pool and
    hit-aware admission."""
    argv = ["--arch", "deepseek-r1", "--n-requests", "4", "--prompt-len",
            "16", "--max-new", "5", "--mtp", "--mtp-fused", "--decode-chunk",
            "4", "--decode-engines", "2", "--decode-router", "cache_affinity",
            "--hit-aware-admission", "--trace"]
    _jax_main(monkeypatch, argv)
    want = capsys.readouterr().out
    monkeypatch.undo()

    def same_params(cfg, seed=0, device=None):
        jp = j_init_params(jax.random.PRNGKey(seed), _jax_cfg(cfg))
        return params_from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, device)

    def same_head(cfg, seed=0, device=None):
        jm = j_mtp.init_mtp_params(jax.random.PRNGKey(seed),
                                   _jax_cfg(cfg))
        return mtp_from_jax_numpy(jax.tree.map(np.asarray, jm), cfg, device)

    monkeypatch.setattr(t_serve, "init_params", same_params)
    monkeypatch.setattr(t_serve, "init_mtp_params", same_head)
    t_serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert "ems: hit_rate=" in got and "decode pool:" in got


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-2b"])
def test_cli_prints_jax_lines_on_gqa_archs(monkeypatch, capsys, arch):
    """The same on two GQA archs (qk-norm; tied embeddings): fused MTP
    with the EMS cache on and a two-engine cache-affinity pool print the
    JAX CLI's lines."""
    argv = ["--arch", arch, "--n-requests", "4", "--prompt-len", "16",
            "--max-new", "5", "--mtp", "--mtp-fused", "--decode-chunk", "4",
            "--decode-engines", "2", "--decode-router", "cache_affinity",
            "--trace"]
    _jax_main(monkeypatch, argv)
    want = capsys.readouterr().out
    monkeypatch.undo()

    def same_params(cfg, seed=0, device=None):
        jp = j_init_params(jax.random.PRNGKey(seed), _jax_cfg(cfg))
        return params_from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, device)

    def same_head(cfg, seed=0, device=None):
        jm = j_mtp.init_mtp_params(jax.random.PRNGKey(seed), _jax_cfg(cfg))
        return mtp_from_jax_numpy(jax.tree.map(np.asarray, jm), cfg, device)

    monkeypatch.setattr(t_serve, "init_params", same_params)
    monkeypatch.setattr(t_serve, "init_mtp_params", same_head)
    t_serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert got.count("rid=") == 4 and "ems: hit_rate=" in got


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi3-medium-14b",
                                  "olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_cli_serves_the_other_gqa_archs(capsys, arch):
    """Every dense and GQA-MoE arch serves through the CLI on the CPU."""
    t_serve.main(["--arch", arch, "--device", "cpu", "--n-requests", "3",
                  "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("rid=") == 3
    assert "SLO summary (virtual clock): completed=3" in out


def test_cli_fit_draft_serves_on_cpu(capsys):
    """The full MTP path of the CLI on the CPU: the draft head distilled on
    the served prompts, fused verify, scanned decode and the EMS cache on.
    Later rids reuse the shared prefix, drafts are accepted (fewer
    iterations than tokens), and the trace parses."""
    t_serve.main(["--arch", "deepseek-r1", "--device", "cpu", "--mtp",
                  "--mtp-fused", "--fit-draft", "--decode-chunk", "4",
                  "--n-requests", "4", "--prompt-len", "24", "--max-new", "8",
                  "--trace"])
    out = capsys.readouterr().out
    rows = re.findall(r"rid=(\d+) prefill@\d+ reused=(\d+) computed=(\d+) "
                      r"iters=(\d+) tokens=\[([^\]]*)\]", out)
    assert len(rows) == 4
    assert all(int(re_) > 0 for rid, re_, *_ in rows if int(rid) > 0)
    iters = [int(r[3]) for r in rows]
    n_tok = [len(r[4].split(",")) for r in rows]
    assert n_tok == [8] * 4 and sum(iters) < sum(n_tok) - 4
    assert "SLO summary (virtual clock): completed=4" in out
    trace = json.loads(out[out.index("\n[") + 1:])
    assert [r["rid"] for r in trace] == [0, 1, 2, 3]


def test_module_entry_point_runs():
    """``python -m repro_torch.launch.serve`` runs as a module."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "deepseek-r1", "--device", "cpu", "--n-requests", "2",
         "--max-new", "3"], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("rid=") == 2 and "transfer:" in out.stdout
