"""The dry run's sharded steps (``launch/sharded_step.py``'s cases: train,
prefill and decode) at smoke width on real tensors, over gloo ranks of a
2 x 2 ``DeviceMesh`` (one subprocess, its ranks forked, under
STEPS_TIMEOUT_S; no JAX: the port against itself):

* each step against the same step unsharded and against the dry run's
  records, the train cases without an INT8 payload also against the same
  step in float64; every case in float64 against the same step unsharded
  in float64, under ``NarrowOps``, and train-mamba2 with ``rms_norm``
  broken; R1's prefill steps through the §4.3.1 hybrid entering it;
  ``decode-r1`` over one rank;
* the INT8 LEP train steps (``train-olmoe``, ``train-r1``): their discrete
  choices (INT8 codes and scales, router picks) against the reference's
  own (``sharded_step.compare_choices``), and the step against the
  reference replayed with its choices at the fixed gates
  (``sharded_step.hold_choices``); ``train-olmoe`` again with a partition
  fault planted (rank 1's token split rolled by one token), which the
  choices gate fails.

In this process: the choices gate on hand-made choices, and the deadline
of ``torch_sharded_common.wait_all`` on a process that overruns it or
fails."""
import time

import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch import sharded_step as ss
from torch_sharded_common import load_ranks, start, start_ranks, wait_all

#: the sharded steps of ``launch/sharded_step.py`` at smoke width, each
#: held against the same step unsharded (float32: decode at 1e-5) and its
#: collective bytes against the dry run's record
STEP_CASES = list(ss.CASES)
REAL_STEP_TOL = 1e-5
#: the INT8 LEP train steps, whose choices are gated and replayed
INT8_CASES = [c for c in STEP_CASES if ss.CASES[c].f32_payload]
PLANTED = "train-olmoe"
#: the ranks' deadline, 3.1 x STEPS_SETUP_S: the fixture's setup beside the
#: other gloo and JAX files under the tier-1 run's flags (as
#: ``test_torch_sharded_lep.py`` measures its own), the longer of two runs
#: (71.4 s in the other)
STEPS_SETUP_S = 78.3
STEPS_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The 2 x 2 ranks' rows under STEPS_TIMEOUT_S: ({"steps": rank 0's
    rows}, None)."""
    tmp = tmp_path_factory.mktemp("sharded_steps")
    started = time.monotonic()
    procs = [start_ranks("2x2", (2, 2), tmp, "", {
        "real_steps": True, "step_tol": REAL_STEP_TOL, "planted": PLANTED})]
    wait_all(procs, STEPS_TIMEOUT_S, started)
    return {"steps": load_ranks(tmp / "2x2.npz")[1]}, None


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_unsharded(sides, case):
    """``dryrun.build_step`` on real tensors at 2 x 2 (every weight drawn
    from the seed and placed one at a time, caches and batch placed by
    the specs) against the same step on plain tensors, the MoE layers
    through the 1-D LEP at world size 1: a train step's loss and global
    gradient norm within 1e-5, each parameter and both moments within 2e-4
    of the leaf's largest; a decode step's logits and caches within 1e-5
    of the largest, greedy tokens equal where the top-2 margin is clear;
    a prefill's logits and caches likewise (``sharded_step.compare``)."""
    ports, _ = sides
    row = ports["steps"]["rows"][case]
    assert row["ok"], row
    if ss.CASES[case].kind != "train":
        assert row["greedy_checked"] > 0, row


@pytest.mark.parametrize("case", [c for c in STEP_CASES if ss.CASES[c].f64])
def test_train_steps_hold_against_float64(sides, case):
    """The train cases without an INT8 payload at 2 x 2 against the same
    step in float64 (``sharded_step.truth``: the float32 step's weights
    and batch widened, on the CPU): each parameter and both moments no
    further from it than the unsharded float32 step plus STEP_TOL of the
    leaf's largest value, the loss and gradient norm within 1e-5 of the
    unsharded step's."""
    ports, _ = sides
    row = ports["steps"]["rows"][case]["f64_gate"]
    assert row["ok"], row
    assert set(row["f64"]["sharded_max_err"]) == {"param", "mu", "nu"}


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_float64_exact(sides, case):
    """Each case's step in float64 at 2 x 2 (``case_step(dtype=float64)``:
    the case's weights drawn as its own step draws them, then widened, as
    each is placed; caches and moments float64) against the same step
    unsharded in float64 over the data ranks' row groups, every gated
    quantity within ``F64_TOL`` = 1e-9 of its largest value: a train
    step's loss and gradient norm, every parameter and both moments; a
    prefill's or decode step's logits on every row (a decode row whose
    cache spans two sequence blocks included), every cache leaf and the
    rows it wrote, and its greedy tokens equal on every row."""
    ports, _ = sides
    row = ports["steps"]["f64"][case]
    assert row["ok"] and not row["over"], row
    assert row["worst_err"] <= ss.F64_TOL, row
    if ss.CASES[case].kind != "train":
        assert len(row["greedy_equal_by_row"]) == row["n_rows"], row
        assert len(row["logits_err_by_row"]) == row["n_rows"], row


#: what a float64 step may compute narrower than float64, by the port's
#: file and function, with the reason: the INT8 payload's per-row scale
#: is float32 bits in its tail (``src/repro/core/lep.py:176-178``)
F64_NARROW = {
    ("repro_torch/kernels/dispatch_quant/ref.py", "dispatch_quantize_ref"):
        "the row's scale rounded once to the payload's float32, its bytes "
        "packed into the tail",
    ("repro_torch/core/lep.py", "_unpack"):
        "the float32 scale read back from the payload's tail"}


def test_float64_steps_compute_in_float64(sides):
    """The eleven float64 steps, sharded (every rank) and unsharded, under
    ``sharded_step.NarrowOps``: no op gives a floating output narrower
    than float64 but those of ``F64_NARROW`` (float32, the INT8 payload's
    scale), which the cases with INT8 dispatch do run."""
    ports, _ = sides
    ops = ports["steps"]["f64_audit"]
    sites = {}
    for key in ops:
        where, func, _, dtype = key.split(" ")
        assert dtype == "float32", key
        sites[(where.rsplit(":", 1)[0], func)] = key
    assert set(sites) == set(F64_NARROW), sorted(ops)


@pytest.mark.parametrize("how", ["perturb", "demote"])
def test_float64_gate_sees_what_the_fixed_gate_cannot(sides, how):
    """train-mamba2 in float64 at 2 x 2 with ``dtensor.rms_norm`` broken
    (rank 0's partial sum of squares off by one part in 1e7, or the body
    computed in float32 again) fails ``F64_TOL`` against the float64
    unsharded step while it passes the fixed gate of ``compare``
    (STEP_TOL, LOSS_RTOL); the demoted body is in the step's
    ``NarrowOps`` record."""
    ports, _ = sides
    row = ports["steps"]["f64_broken"][how]
    assert not row["f64"]["ok"], row["f64"]
    assert ss.F64_TOL < row["f64"]["worst_err"] < ss.STEP_TOL, row["f64"]
    assert row["fixed"]["ok"], row["fixed"]
    in_norm = [k for k in row["audit"]
               if k.startswith("repro_torch/dtensor.py:")]
    assert bool(in_norm) == (how == "demote"), row["audit"]


def test_hybrid_prefill_step_enters_the_hybrid(sides):
    """The hybrid prefill cases run ``mla_prefill_hybrid`` on each of the
    4 MLA layers of R1's cut with their o-proj mode, the plain one on
    none; a block that sets the mode but never enters the hybrid raises
    (``dryrun.hybrid_prefill``): a prefill that took the plain path is not
    taken for the hybrid's."""
    ports, _ = sides
    rows = ports["steps"]["rows"]
    assert rows["prefill-r1-a2a"]["hybrid_calls"] == {"a2a": 4, "rs": 0}
    assert rows["prefill-r1-rs"]["hybrid_calls"] == {"a2a": 0, "rs": 4}
    assert rows["prefill-r1"]["hybrid_calls"] == {"a2a": 0, "rs": 0}
    with pytest.raises(AssertionError, match="ran on 0 MLA layers, not 4"):
        with dryrun.hybrid_prefill("a2a", None, 4):
            pass


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_collectives_equal_record(sides, case):
    """The collective bytes by kind (and their count) that
    ``CollectiveCounter`` sees on rank 0 of the executed 2 x 2 step equal
    the dry run's record of the same case on a fake 2 x 2 group
    (``dryrun._measure``), byte for byte."""
    ports, _ = sides
    counts = ports["steps"]["rows"][case]["counts"]
    assert counts == ports["steps"]["records"][case]
    assert counts["count"] > 0


def test_sharded_step_one_rank_counts_nothing(sides):
    """``decode-r1`` over a 1 x 1 mesh of one gloo rank: equal to the
    unsharded step, no collective counted, as the 1 x 1 record reads."""
    ports, _ = sides
    row = ports["steps"]["one_rank"]
    assert row["ok"], row
    assert not any(row["counts"].values())
    assert row["counts"] == ports["steps"]["one_rank_record"]


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_lep_steps_hold_choices_and_replay(sides, case):
    """An INT8 LEP train step at 2 x 2: every INT8 code within one of the
    reference's own, every scale within ``SCALE_RTOL``, every flipped
    router pick within ``PICK_RTOL`` of its token's largest probability
    (``sharded_step.compare_choices``), at least one MoE layer's choices
    recorded on every row; and the step against the reference run again
    with the step's choices in place of its own, at the fixed gates of
    ``sharded_step.compare`` (loss and gradient norm 1e-5, parameters and
    moments 2e-4)."""
    ports, _ = sides
    row = ports["steps"]["rows"][case]
    assert row["choices"]["ok"], row["choices"]
    layers = row["choices"]["by_layer"]
    assert len(layers) == ss.moe_layers(ss.case_config(case, smoke=True))
    shape = ss.case_shape(case, smoke=True)
    assert all(r["tokens"] == shape.global_batch * shape.seq_len
               for r in layers), layers
    assert row["replay"]["ok"], row["replay"]


def test_planted_partition_fault_fails_choices(sides):
    """``train-olmoe``'s INT8 step with rank 1's token split rolled by one
    token (each of its tokens in its neighbour's place): the choices gate
    fails, its codes more than one apart and its scales off."""
    ports, _ = sides
    row = ports["steps"]["planted"][PLANTED]
    assert not row["choices"]["ok"], row["choices"]
    assert row["choices"]["codes_max_apart"] > ss.CODE_APART
    assert "scale_max_rel_err" in row["choices"]["over"]


def _choices(gen, tokens=6, k=2, e=8, d=5):
    """Hand-made choices of one MoE layer: the reference's own (with its
    probabilities) and a copy."""
    probs = torch.softmax(torch.randn(tokens, e, generator=gen), -1)
    top = probs.sort(dim=-1, descending=True, stable=True).indices[:, :k]
    x = torch.randn(tokens, d, generator=gen)
    scale = x.abs().amax(-1) / 127
    codes = torch.round(x / scale[:, None]).to(torch.int8)
    want = {0: {"top_i": top, "probs": probs, "codes": codes,
                "scale": scale}}
    got = {0: {k: v.clone() for k, v in want[0].items() if k != "probs"}}
    return got, want


@pytest.mark.parametrize("what", ["equal", "one_apart", "two_apart",
                                  "scale_rounded", "scale_off",
                                  "pick_near_tie", "pick_flipped"])
def test_choices_gate_on_hand_made_choices(what):
    """``sharded_step.compare_choices``: codes one apart pass (and are
    counted), two apart fail; a scale within SCALE_RTOL passes, one 1e-3
    off fails; a pick flipped between two experts the reference ranks
    within PICK_RTOL of the token's largest probability passes (and is
    counted), one flipped to the token's least likely expert fails."""
    gen = torch.Generator().manual_seed(0)
    got, want = _choices(gen)
    g, w = got[0], want[0]
    over = []
    col = int((w["codes"][2].abs() < 120).nonzero()[0])   # no int8 overflow
    if what == "one_apart":
        g["codes"][2, col] += 1
    elif what == "two_apart":
        g["codes"][2, col] -= 2
        over = ["codes_max_apart"]
    elif what == "scale_rounded":
        g["scale"][3] *= 1 + 0.5 * ss.SCALE_RTOL
    elif what == "scale_off":
        g["scale"][3] *= 1 + 1e-3
        over = ["scale_max_rel_err"]
    elif what == "pick_near_tie":
        k = w["top_i"].shape[1]
        order = w["probs"][4].sort(descending=True, stable=True).indices
        # the reference's k-th and (k+1)-th experts a rounding apart
        w["probs"][4, order[k]] = w["probs"][4, order[k - 1]] * (1 - 1e-7)
        g["top_i"][4, k - 1] = order[k]
    elif what == "pick_flipped":
        g["top_i"][4, -1] = w["probs"][4].argmin()
        over = ["flip_max_margin"]
    row = ss.compare_choices(got, want)
    assert row["over"] == over, row
    assert row["ok"] == (not over)
    if what == "one_apart":
        assert row["codes_one_apart_share"] == 1 / w["codes"].numel()
    if what.startswith("pick"):
        assert row["picks_flipped"] == row["tokens_flipped"] == 1, row


@pytest.mark.parametrize("how", ["overrun", "crash"])
def test_deadline_names_the_process_and_its_stderr(tmp_path, how):
    """``wait_all`` over a process that sleeps past a 2 s deadline, or one
    that exits with 3: the error names the process and carries the tail of
    its stderr, and no process is left running."""
    script = tmp_path / "slow.py"
    script.write_text("import sys, time\n"
                      "print('last words of the slow one', file=sys.stderr,"
                      " flush=True)\n"
                      f"{'time.sleep(60)' if how == 'overrun' else 'sys.exit(3)'}\n")
    quick = tmp_path / "quick.py"
    quick.write_text("pass\n")
    procs = [start("quick", quick, [], tmp_path),
             start("slow-one", script, [], tmp_path)]
    started = time.monotonic()
    with pytest.raises(AssertionError) as err:
        wait_all(procs, 2.0, started)
    msg = str(err.value)
    assert "slow-one" in msg and "last words of the slow one" in msg, msg
    assert ("overran the deadline of 2 s" in msg) == (how == "overrun"), msg
    assert ("exited with 3" in msg) == (how == "crash"), msg
    assert time.monotonic() - started < 30
    assert all(p.poll() is not None for p in procs)
