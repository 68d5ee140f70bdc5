"""raft_tpu_torch.profiles.pair_cut_ties: its counts on rows made by hand,
and one small run on the CPU, where the wrappers run their plain versions
and so nothing past the pair count can differ."""

import pytest
import torch

from raft_tpu_torch.profiles import pair_cut_ties as pct

INF = float("inf")


def test_cut_flips_counts_pairs_whose_kept_rows_differ():
    kv = torch.tensor([[[1.0, 2.0], [3.0, 9.0]], [[1.0, 5.0], [2.0, INF]]])
    ki = torch.tensor([[[1, 2], [3, 4]], [[5, 6], [7, -1]]])
    pi = torch.tensor([[[2, 1], [3, 8]], [[5, 9], [7, -1]]])
    pv = kv.clone()
    merged = torch.tensor([[1.0, 2.0, 3.0], [1.0, 2.0, 6.0]])
    # pair (0, 0) keeps the same set in another order; (0, 1) and (1, 0)
    # differ, their last kept rows (9.0, 5.0) past their queries' top
    # k - 1 (2.0, 2.0) until query 1's reaches 5.5
    assert pct.cut_flips(kv, ki, pv, pi, merged) == {
        "pairs": 4, "cut_flips": 2, "inside": 0}
    merged[1, -2] = 5.5
    assert pct.cut_flips(kv, ki, pv, pi, merged)["inside"] == 1


@pytest.mark.parametrize("vals, plain_ids, recomputed, expected", [
    # two ids of equal distance swapped next to each other
    ([1.0, 2.0, 2.0, 4.0], [10, 12, 11, 13], {}, (2, 0, 0)),
    # a partner cut at the pair's top kt: recomputed within the tolerance
    ([1.0, 2.0, 3.0, 4.0], [10, 99, 12, 13], {99: 2.000001}, (1, 1, 0)),
    # a wrong id at rank 1
    ([1.0, 2.0, 3.0, 4.0], [10, 99, 12, 13], {99: 2.5}, (1, 1, 1)),
    # the last rank's partner lies past the row
    ([1.0, 2.0, 3.0, 4.0], [10, 11, 12, 99], {99: 7.0}, (1, 0, 0)),
])
def test_off_ties_classifies_each_differing_rank(vals, plain_ids, recomputed,
                                                 expected):
    vk = torch.tensor([vals])
    ik = torch.tensor([[10, 11, 12, 13]])
    table = {10: vals[0], 11: vals[1], 12: vals[2], 13: vals[3],
             **recomputed}

    def dist_of(q, ids):
        return torch.tensor([table[int(i)] for i in ids])

    got = pct.off_ties(vk, ik, torch.tensor([plain_ids]), dist_of)
    assert (got["differing_ranks"], got["off_adjacent"],
            got["off_ties"]) == expected


def test_run_on_the_cpu_counts_pairs_and_no_differences():
    lines = list(pct.run(3_000, 16, 16, 8, 0.5, 2, torch.device("cpu"),
                         n_probes=4, kt=2, k=5))
    assert [line["batch"] for line in lines] == [0, 1]
    assert lines[-1] == {"batch": 1, "pairs": 2 * 5_000 * 4, "cut_flips": 0,
                         "inside": 0, "differing_ranks": 0,
                         "off_adjacent": 0, "off_ties": 0}
