"""The distillation cell at a tiny size on the CPU: a run of the timed path
is correct, each planted fault reads over its limit, the reference's bank
against hand-built cases, the program's bank and k-means against the
reference's, the k-means counters against the reference's count, and the
reference imports nothing of the program."""
from __future__ import annotations

import ast
import os
import time

import pytest
import torch

from benchmark import cells, distill, distill_control, run
from benchmark.reference import distill as rd
from benchmark.tests.tiny import tiny_cell

CELL = "distill-train-p3"
ROOT = cells.ROOT
DEVICE = {"platform": "cpu", "kind": "test", "count": 1,
          "memory_peak_bytes": 0}
# The number a fault is planted to move.
FAULT_NUMBER = {"half_batch": "loss_gap", "frozen_bank": "bank_gap",
                "unsnapped": "snap_gap"}


def _run(fault=None, seed=23):
    cell = tiny_cell(CELL)
    rec = distill.run(cell, seed, 0.3, False, time.perf_counter(), "cpu",
                      step_hook=fault)
    return cell, rec, run.result_line(cell, rec, False, DEVICE)[0]


def test_a_sound_run_is_correct():
    cell, rec, out = _run(seed=2 ** 31 + 29)
    assert out["correct"] is True, out["check"]
    assert rec["numbers"]["near_ties"] >= 0
    # Counted from the window's first step: 32 iterations issued per solve,
    # a solve per image and stream.
    B = cell.traffic["batch"]
    assert rec["kmeans_issued"] == 32 * 2 * B * rec["steps"]
    assert 2 * B * rec["steps"] <= rec["kmeans_iters"] <= rec["kmeans_issued"]


@pytest.mark.parametrize("fault", sorted(distill_control.FAULTS))
def test_a_planted_fault_reads_over_its_limit(fault):
    """The checked steps with the fault planted, as the control's readings
    take them."""
    cell = tiny_cell(CELL)
    r = distill_control.readings(cell, 23, True, False, "cpu",
                                 distill_control.FAULTS[fault])["program"]
    name = FAULT_NUMBER[fault]
    assert r[name] > cell.limits[name], (fault, r)


def test_the_pool_pairs_share_images_and_boxes():
    cell = tiny_cell(CELL)
    pair = distill.inputs(cell, 5, "cpu")["pool"][0]
    noun, sth = pair["noun"], pair["sth"]
    for k in distill.SHARED:
        assert noun[k] is sth[k]
    for i in range(noun["box_valid"].shape[0]):
        lo, hi = sth["caption_noun_span"][i]
        assert lo == hi and sth["text_ids"][i, hi + 1] == 2      # then EOS
        v = lo - 1                                    # the verb's ids
        assert (noun["text_ids"][i, 1:1 + v] == sth["text_ids"][i, 1:1 + v]
                ).all()
        spans = noun["noun_token_spans"][i][noun["box_valid"][i]]
        assert (spans[:, 0] == 1 + v).all()
        assert noun["text_ids"][i, spans[0, 1] + 1] == 2
        assert (noun["caption_noun_span"][i] == -1).all()


def _bank(full, count, T=3, M=4, D=2, K=2):
    g = torch.Generator().manual_seed(0)
    return rd.Bank({"feature_bank": torch.randn(T, M, D, generator=g),
                    "cluster_centers": torch.randn(T, K, D, generator=g),
                    "update_count": torch.tensor(count),
                    "full": torch.tensor(full)})


def test_reference_bank_push_by_hand():
    b = _bank([True, False, False], [5, 4, 0])
    f = torch.tensor([[0.5, -1.0], [2.0, 2.0], [3.0, 3.0]])
    before = b.fb.clone()
    near = int((before[0] - f[0]).abs().sum(-1).argmin())
    b.push(f, [0, 1, 2], [True, True, False])
    # Full: the L1-nearest row is replaced, the others stay.
    assert torch.equal(b.fb[0, near], f[0])
    keep = [j for j in range(4) if j != near]
    assert torch.equal(b.fb[0, keep], before[0, keep])
    # Not full: shifted in at the end, first in first out.
    assert torch.equal(b.fb[1], torch.cat([before[1, 1:], f[1][None]]))
    # An invalid row changes nothing.
    assert torch.equal(b.fb[2], before[2]) and b.count[2] == 0
    assert b.count[:2] == [6, 5]


def test_reference_full_flag_quirk():
    """A task turns full on its memory size + 2-th push: the flag is set
    when the count before the push exceeds the memory size."""
    b = _bank([False] * 3, [4, 0, 0])
    b.fb[0] = torch.tensor([[0.0, 0], [10, 10], [20, 20], [30, 30]])
    b.push(torch.tensor([[1.0, 1]]), [0], [True])      # count 4 -> 5
    assert b.full[0] is False and b.count[0] == 5
    b.push(torch.tensor([[2.0, 2]]), [0], [True])      # 5 > 4: full after
    assert b.full[0] is True
    assert b.fb[0].tolist() == [[20, 20], [30, 30], [1, 1], [2, 2]]
    b.push(torch.tensor([[29.0, 29]]), [0], [True])    # replaces [30, 30]
    assert b.fb[0].tolist() == [[20, 20], [29, 29], [1, 1], [2, 2]]


def test_reference_kmeans_empty_cluster_and_warm_start():
    x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0]])
    far = torch.tensor([[0.0, 0.0], [5.0, 5.0], [100.0, 100.0]])
    c, it = rd.lloyd(x, far, 32, 1e-4)
    assert torch.equal(c[2], far[2])                   # empty: kept
    assert torch.allclose(c[:2], torch.tensor([[0.05, 0.0], [5.05, 5.0]]))
    assert it == 2                     # one move, then one that stops
    # Two images of one task: the second starts from the first's centres.
    b = _bank([True] * 3, [9] * 3, M=8, K=2)
    once, _ = rd.lloyd(b.fb[1], b.cc[1], 1, 0.0)
    twice, _ = rd.lloyd(b.fb[1], once, 1, 0.0)
    b.select(torch.zeros(2, 2), [1, 1], [True, True], 1, 0.0)
    assert torch.allclose(b.cc[1], twice)


def test_program_bank_matches_the_reference():
    from toist_tpu_torch.ops.kmeans import kmeans_counted
    from toist_tpu_torch.train import cluster as cl

    g = torch.Generator().manual_seed(3)
    T, M, D, K = 3, 64, 8, 3
    state = {"feature_bank": torch.randn(T, M, D, generator=g),
             "cluster_centers": torch.randn(T, K, D, generator=g),
             "update_count": torch.tensor([M + 1, M + 1, 2]),
             "full": torch.tensor([True, True, False])}
    feats = torch.randn(4, D, generator=g)
    tasks, valid = [0, 2, 0, 1], [True, True, True, True]
    bank = cl.ClusterBank(**{k: v.clone() for k, v in state.items()})
    bank = cl.update_bank(bank, feats, torch.tensor(tasks),
                          torch.tensor(valid))
    bank, chosen, choices, iters = cl.cluster_select(
        bank, feats, torch.tensor(tasks), torch.tensor(valid), 32, 1e-4)
    ref = rd.Bank(state)
    ref.push(feats, tasks, valid)
    centres, ref_choices, ref_iters = ref.select(feats, tasks, valid, 32,
                                                 1e-4)
    assert torch.equal(bank.feature_bank, ref.fb)
    assert bank.update_count.tolist() == ref.count
    assert bank.full.tolist() == ref.full
    torch.testing.assert_close(bank.cluster_centers, ref.cc, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(chosen, centres, rtol=1e-5, atol=1e-5)
    assert choices.tolist() == ref_choices
    assert int(iters) == ref_iters
    _, c, it = kmeans_counted(state["feature_bank"][1],
                              state["cluster_centers"][1], 32, 1e-4)
    rc, rit = rd.lloyd(state["feature_bank"][1],
                       state["cluster_centers"][1], 32, 1e-4)
    torch.testing.assert_close(c, rc, rtol=1e-5, atol=1e-5)
    assert int(it) == rit


def test_kmeans_counters_match_the_reference():
    """The checked steps' ``kmeans_iters`` equal the reference's count of
    iterations over the same solves."""
    cell = tiny_cell(CELL)
    s = distill.checked_setup(cell, 41, "cpu")
    ref = distill.reference_steps(cell, s, 41, "cpu",
                                  feed=s["program"]["pooled"])
    assert s["program"]["kmeans_iters"] == ref["kmeans_iters"]
    assert all(n >= 2 * cell.traffic["batch"] for n in ref["kmeans_iters"])


def test_the_reference_imports_nothing_of_the_program():
    """Every import of ``reference/distill.py`` and of the reference
    modules it imports, read from their source."""
    names, todo, seen = set(), ["benchmark.reference.distill"], set()
    while todo:
        mod = todo.pop()
        seen.add(mod)
        path = os.path.join(ROOT, *mod.split(".")) + ".py"
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                got = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                got = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for name in got:
                names.add(name.split(".")[0])
                if name.startswith("benchmark.") and name not in seen \
                        and os.path.exists(os.path.join(
                            ROOT, *name.split(".")) + ".py"):
                    todo.append(name)
    assert seen == {"benchmark.reference.distill",
                    "benchmark.reference.toist", "benchmark.reference.train"}
    assert not names & (set(run.FORBIDDEN) | {"toist_tpu_torch"})
