"""Kernels F, G, D and E's pair-group pass (``csrc/pair_list_scan.cu``) in
turns with the kernels beside it on one card: at chip_smoke's k-100
shapes with the query-major kernel it replaced (``csrc/pair_scan.cu``;
D and E: ``csrc/pq_code_scan.cu``, ``csrc/pq_recon8_scan.cu``), at each
group size the pass takes, and at Kernel F's k-10 shapes with the list-major pass
(``csrc/flat_list_scan.cu``) that keeps kt up to 64.

Run by path from the root of a checkout (``codes``: D and E only;
``fused``: B and C only)::

    python3 raft_tpu_torch/profiles/pair_list_turns.py [codes | fused]

``fused`` times Kernels B and C's pair-group route (G's or D's pass as
pass 1 of ``list_major_topk``, then ``merge_pairs``) at each group size
that fits beside the query-major kernel it replaced
(``scan_query_major`` / ``codes_fused_query_major``) in one palindrome,
then pass 2 alone beside ``torch.topk`` over the same (nq, n_probes * kt)
pairs (merge, topk, topk, merge; the values held equal): B on the
flagship's lists (k = kt 65, 128, 200, 256 on 1,000 queries, 200 on
5,000), C on the deep index's (k = kt 65, 100, 128 on 1,000) and on the
flagship's 64 8-bit codes of rot 128 at k = kt 41 and 64 (1,000 and
5,000 queries), where C's list-major books do not fit and the route
takes the pass at kt up to 64 too.

It draws random lists on the card from a fixed seed at the shapes
chip_smoke holds these routes at — IVF-Flat nlist 4096's 2,048 super-tiles
of up to 832 fp32 rows of dim 128 (F at kt 100, 64 probes, 1,000 and 5,000
queries; kt 256; kt 10 on 5,000 queries), IVF-Flat nlist 16384's 4,096
super-tiles of up to 640 rows (F 4; kt 10, 128 probes, 5,000 queries) and
the flagship's 4,096 lists of up to 416 bf16 rows of rot 128 (G at kt
128, 96 probes, 1,000 queries), and the deep index's shape, 8,192 lists
of up to 1,856 rows (mean about 1,237, the deep build's 1,221) of 48
8-bit codes (D) and of 96 int8 values (E), kt 128, 96 probes, 1,000 and
5,000 queries — and prints one JSON line a shape: the CUDA-event ms
(grouping included) of the pair-group pass at each group size (``group``
given explicitly) and of the other kernel, in turns (pass, other, other,
pass) at each group size; for D and E every variant and the query-major
kernel in one palindrome (each variant, the kernel, then the same in
reverse order).  The card's name and power limit come first.  The group
size ``pair_list_layout`` picks first is the one these turns justify;
the k-10 turns say what the list-major pass is worth beside the pass.
It runs on the card only.
"""

import json
import os
import subprocess
import sys

NQ = 1_000


def lists(g, n_lists, cap, dev):
    """ids (n_lists, cap) int32: each list's first size slots hold fresh
    ids, size uniform in [cap / 3, cap], the rest -1."""
    import torch

    sizes = torch.randint(cap // 3, cap + 1, (n_lists, 1), generator=g,
                          device=dev)
    slot = torch.arange(cap, device=dev)[None, :]
    live = slot < sizes
    ids = torch.cumsum(live.reshape(-1).int(), 0).reshape(n_lists, cap) - 1
    return torch.where(live, ids, torch.full_like(ids, -1)).int()


def probes_of(g, nq, n_lists, n_probes, dev):
    """(nq, n_probes) int32: distinct lists for each query."""
    import torch

    keys = torch.rand(nq, n_lists, generator=g, device=dev)
    return keys.topk(n_probes, dim=1).indices.int()


def turns(label, pair, other, other_name, width, kt, fp32, groups):
    """The pair-group pass (``pair(group)``) at each of ``groups`` the
    shape takes and ``other`` in turns; one JSON line."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from raft_tpu_torch.core.error import LogicError
    from raft_tpu_torch.ops import pair_scan as ps

    out = {"shape": label}
    for group in groups:
        try:
            ps.pair_list_layout(width, kt, fp32, group=group)
        except LogicError:         # past shared memory at this size
            continue
        # pass, other, other, pass
        p1 = cs.cuda_ms(lambda: pair(group), cs.KERNEL_REPS)
        o1 = cs.cuda_ms(other, cs.KERNEL_REPS)
        o2 = cs.cuda_ms(other, cs.KERNEL_REPS)
        p2 = cs.cuda_ms(lambda: pair(group), cs.KERNEL_REPS)
        out[f"pair_group{group}_ms"] = [p1, p2]
        out[other_name] = out.get(other_name, []) + [o1, o2]
    out["group_picked"] = ps.pair_list_layout(width, kt, fp32).group
    print(json.dumps(out), flush=True)


def flat_turns(g, n_tiles, rows, F, shapes, dev):
    """Kernel F on ``n_tiles`` super-tiles of ``rows`` slots (``F``
    sub-lists each): each (nq, n_probes, kt) of ``shapes``, the pass
    beside the query-major kernel past kt 64, else beside the list-major
    pass."""
    import torch
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pair_scan as ps

    dim = 128
    data = torch.randn(n_tiles, rows, dim, generator=g, device=dev)
    ids = lists(g, n_tiles, rows, dev)
    dsq = (data * data).sum(-1)
    for nq, n_probes, kt in shapes:
        q = torch.randn(nq, dim, generator=g, device=dev)
        probes = probes_of(g, nq, n_tiles, n_probes, dev)

        def pair(group, q=q, probes=probes, kt=kt):
            return ps.flat_pair_list_scan(
                q, probes, *grouped.build_groups(probes, n_tiles, group),
                data, dsq, ids, kt, sub_lists=F, group=group)
        label = (f"F {nq:,} q x {n_probes} probes, {n_tiles} tiles of "
                 f"{rows} (F {F}), kt {kt}")
        if kt > ps.KT_LIST_MAX:
            turns(label, pair, lambda q=q, probes=probes, kt=kt:
                  ps.flat_scan_query_major(q, probes, data, dsq, ids, kt),
                  "query_major_ms", dim, kt, True, (64, 32, 16))
        else:
            turns(label, pair, lambda q=q, probes=probes, kt=kt:
                  ps.flat_list_scan(
                      q, probes, *grouped.build_groups(probes, n_tiles),
                      data, dsq, ids, kt, sub_lists=F),
                  "list_major_ms", dim, kt, True, (64, 32))


def palindrome(label, variants, other, other_name, picked):
    """Each of ``variants`` (name -> call) and ``other`` timed in one
    palindrome order (the variants, ``other``, then the same reversed):
    two CUDA-event ms each; one JSON line."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    calls = dict(variants, **{other_name: other})
    order = list(calls) + list(calls)[::-1]
    out = {"shape": label}
    for name in order:
        out.setdefault(name, []).append(cs.cuda_ms(calls[name],
                                                   cs.KERNEL_REPS))
    out.update(picked)
    print(json.dumps(out), flush=True)


def code_turns(g, dev):
    """Kernels D and E at the deep index's shape, kt 128, 96 probes, 1,000
    and 5,000 queries: the pair-group pass at each group size beside the
    query-major kernel, in a palindrome."""
    import torch
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pq_code_scan as pcs

    n_lists, cap, pq_dim, pq_len, bits, kt = 8192, 1856, 48, 2, 8, 128
    rot = pq_dim * pq_len
    codes = torch.randint(0, 256, (n_lists, cap, pq_dim), generator=g,
                          device=dev, dtype=torch.uint8)
    books = torch.randn(pq_dim, 1 << bits, pq_len, generator=g, device=dev)
    rsq = torch.cat([(pcs.decode_codes(codes[s:s + 512], books, bits)
                      .float() ** 2).sum(-1)
                     for s in range(0, n_lists, 512)])
    i8 = torch.randint(-127, 128, (n_lists, cap, rot), generator=g,
                       device=dev, dtype=torch.int8)
    scales = torch.rand(n_lists, generator=g, device=dev) * 0.1 + 0.01
    rsq8 = scales[:, None] ** 2 * (i8.float() ** 2).sum(-1)
    ids = lists(g, n_lists, cap, dev)
    centers = torch.randn(n_lists, rot, generator=g, device=dev)
    for nq in (NQ, 5 * NQ):
        qrot = torch.randn(nq, rot, generator=g, device=dev)
        probes = probes_of(g, nq, n_lists, 96, dev)
        shape = (f"{nq:,} q x 96 probes, {n_lists} lists of {cap}, rot "
                 f"{rot}, kt {kt}")
        variants = {
            f"pair_group{group}_ms":
                lambda group=group, qrot=qrot, probes=probes:
                pcs.code_pair_list_scan(
                    qrot, centers, probes,
                    *grouped.build_groups(probes, n_lists, group), codes,
                    books, rsq, ids, bits, kt, group=group)
            for group in (64, 32, 16)}
        palindrome(
            f"D {shape}, {bits}-bit codes of {pq_dim} subspaces", variants,
            lambda qrot=qrot, probes=probes: pcs.codes_scan_query_major(
                qrot, centers, probes, codes, books, rsq, ids, bits, kt),
            "query_major_ms",
            {"group_picked":
                pcs.code_pair_list_layout(rot, pq_dim, bits, kt).group})
        variants = {
            f"pair_group{group}_ms":
                lambda group=group, qrot=qrot, probes=probes:
                pcs.recon8_pair_list_scan(
                    qrot, centers, probes,
                    *grouped.build_groups(probes, n_lists, group), i8,
                    scales, rsq8, ids, kt, group=group)
            for group in (64, 32, 16)}
        palindrome(
            f"E {shape}, int8 rows of {rot} B", variants,
            lambda qrot=qrot, probes=probes: pcs.recon8_scan_query_major(
                qrot, centers, probes, i8, scales, rsq8, ids, kt),
            "query_major_ms",
            {"group_picked": pcs.recon8_pair_list_layout(rot, kt).group})


def fitting(layout_at):
    """The group sizes 64 and 32 whose layout (``layout_at(group)``) fits
    the card's shared memory."""
    from raft_tpu_torch.core.error import LogicError

    out = []
    for group in (64, 32):
        try:
            layout_at(group)
        except LogicError:
            continue
        out.append(group)
    return out


def route_turns(label, n_lists, k, probes, pass_at, walked, groups, picked):
    """B or C's route (``pass_at(group, ...)`` as pass 1 of
    ``list_major_topk``) at each of ``groups`` and the query-major kernel
    ``walked`` in a palindrome, then pass 2 alone on the picked group's
    pairs beside ``torch.topk``; two JSON lines."""
    import torch
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pq_group_scan as pgs

    def route(group):
        return pgs.list_major_topk(
            probes, n_lists, k, k,
            lambda rows, p, gl, sp: pass_at(group, rows, p, gl, sp), group)

    palindrome(label, {f"route_group{g}_ms": lambda g=g: route(g)
                       for g in groups},
               walked, "query_major_ms", {"group_picked": picked})
    nq = probes.shape[0]
    pv, pi = pass_at(picked, slice(0, nq), probes,
                     *grouped.build_groups(probes, n_lists, picked))
    flat = pv.reshape(nq, -1)

    def topk():
        return torch.topk(flat, k, dim=1, largest=False)
    assert torch.equal(pgs.merge_pairs(pv, pi, k)[0], topk()[0]), (
        f"{label}: merge and topk values differ")
    palindrome(f"{label}, pass 2", {"merge_pairs_ms": lambda: pgs.merge_pairs(
        pv, pi, k)}, topk, "torch_topk_ms",
        {"candidates_a_query": flat.shape[1]})


def fused_b_turns(g, dev):
    """Kernel B at the flagship's shape: G's pass + merge against
    ``scan_query_major``."""
    import torch
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_group_scan as pgs

    n_lists, cap, rot = 4096, 416, 128
    recon = (torch.randn(n_lists, cap, rot, generator=g, device=dev)
             * 0.125).to(torch.bfloat16)
    rsq = (recon.float() ** 2).sum(-1)
    ids = lists(g, n_lists, cap, dev)
    centers = torch.randn(n_lists, rot, generator=g, device=dev) * 0.125
    for nq, k in ((NQ, 65), (NQ, 128), (NQ, 200), (NQ, 256), (5 * NQ, 200)):
        qrot = torch.randn(nq, rot, generator=g, device=dev) * 0.125
        probes = probes_of(g, nq, n_lists, 96, dev)

        def pass_at(group, rows, p, gl, sp, qrot=qrot, k=k):
            return ps.recon_pair_list_scan(
                qrot[rows], centers, p, gl, sp, recon, rsq, ids, k,
                group=group)
        route_turns(
            f"B {nq:,} q x 96 probes, {n_lists} lists of {cap}, rot {rot}, "
            f"k = kt = {k}", n_lists, k, probes, pass_at,
            lambda qrot=qrot, probes=probes, k=k: pgs.scan_query_major(
                qrot, centers, probes, recon, rsq, ids, k, k),
            fitting(lambda gr, k=k: ps.pair_list_layout(rot, k, False,
                                                        group=gr)),
            ps.pair_list_layout(rot, k, False).group)


def fused_c_turns(g, dev, n_lists, cap, pq_dim, shapes):
    """Kernel C on ``n_lists`` lists of up to ``cap`` rows of ``pq_dim``
    8-bit codes (pq_len 2): D's pass + merge against
    ``codes_fused_query_major`` at each (nq, k = kt) of ``shapes``."""
    import torch
    from raft_tpu_torch.ops import pq_code_scan as pcs

    pq_len, bits = 2, 8
    rot = pq_dim * pq_len
    codes = torch.randint(0, 256, (n_lists, cap, pq_dim), generator=g,
                          device=dev, dtype=torch.uint8)
    books = torch.randn(pq_dim, 1 << bits, pq_len, generator=g,
                        device=dev) * 0.125
    rsq = torch.cat([(pcs.decode_codes(codes[s:s + 512], books, bits)
                      .float() ** 2).sum(-1)
                     for s in range(0, n_lists, 512)])
    ids = lists(g, n_lists, cap, dev)
    centers = torch.randn(n_lists, rot, generator=g, device=dev) * 0.125
    for nq, k in shapes:
        assert pcs.codes_fused_route(cap, rot, pq_dim, bits, k, k)[0] == \
            "pair"
        qrot = torch.randn(nq, rot, generator=g, device=dev) * 0.125
        probes = probes_of(g, nq, n_lists, 96, dev)

        def pass_at(group, rows, p, gl, sp, qrot=qrot, k=k):
            return pcs.code_pair_list_scan(
                qrot[rows], centers, p, gl, sp, codes, books, rsq, ids,
                bits, k, group=group)
        route_turns(
            f"C {nq:,} q x 96 probes, {n_lists} lists of {cap}, "
            f"{pq_dim} {bits}-bit codes of rot {rot}, k = kt = {k}",
            n_lists, k, probes, pass_at,
            lambda qrot=qrot, probes=probes, k=k: pcs.codes_fused_query_major(
                qrot, centers, probes, codes, books, rsq, ids, bits, k, k),
            fitting(lambda gr, k=k: pcs.code_pair_list_layout(
                rot, pq_dim, bits, k, gr)),
            pcs.code_pair_list_layout(rot, pq_dim, bits, k).group)


def main() -> None:
    import torch

    sys.path.insert(0, os.getcwd())
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.profiles import require_cuda

    dev = require_cuda()
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    if sys.argv[1:] == ["codes"]:
        code_turns(g, dev)
        return
    if sys.argv[1:] == ["fused"]:
        fused_b_turns(g, dev)
        torch.cuda.empty_cache()
        # the deep index's shape past kt 64, then the flagship's codes,
        # whose 64 x 256 books leave the list-major pass past kt 40
        fused_c_turns(g, dev, 8192, 1856, 48,
                      ((NQ, 65), (NQ, 100), (NQ, 128)))
        torch.cuda.empty_cache()
        fused_c_turns(g, dev, 4096, 416, 64,
                      ((NQ, 41), (NQ, 64), (5 * NQ, 64)))
        return

    # IVF-Flat nlist 4096's super-tiles (F 2): kt 100 and 256, then k 10
    flat_turns(g, 2048, 832, 2, ((NQ, 64, 100), (5 * NQ, 64, 100),
                                 (NQ, 64, 256), (5 * NQ, 64, 10)), dev)
    torch.cuda.empty_cache()
    # IVF-Flat nlist 16384's super-tiles (F 4) at k 10
    flat_turns(g, 4096, 640, 4, ((5 * NQ, 128, 10),), dev)
    torch.cuda.empty_cache()

    # the flagship's lists: G at kt 128
    n_lists, cap, rot = 4096, 416, 128
    recon = torch.randn(n_lists, cap, rot, generator=g,
                        device=dev).to(torch.bfloat16)
    rsq = (recon.float() ** 2).sum(-1)
    ids = lists(g, n_lists, cap, dev)
    centers = torch.randn(n_lists, rot, generator=g, device=dev)
    qrot = torch.randn(NQ, rot, generator=g, device=dev)
    probes = probes_of(g, NQ, n_lists, 96, dev)
    common = (qrot, centers, probes, recon, rsq, ids)

    def pair(group):
        return ps.recon_pair_list_scan(
            qrot, centers, probes,
            *grouped.build_groups(probes, n_lists, group), recon, rsq, ids,
            128, group=group)
    turns(f"G {NQ:,} q x 96 probes, {n_lists} lists of {cap}, kt 128",
          pair, lambda: ps.recon_scan_query_major(*common, 128),
          "query_major_ms", rot, 128, False, (64, 32, 16))
    del recon, rsq, ids, centers, qrot, probes, common
    torch.cuda.empty_cache()

    # the deep index's shape: D and E at kt 128
    code_turns(g, dev)


if __name__ == "__main__":
    main()
