"""One rank of a gloo session of the port's parallel layer on the CPU.

    python tests/_torch_parallel_worker.py RANK WORLD INIT_FILE OUT_DIR

Started WORLD times by tests/test_torch_parallel.py.  It imports torch
and bgn_torch only (no JAX), joins the group through a file:// store,
runs the data-parallel ops, replicate, both sharded decrypts on both
routes, the stage pipeline and the multihost checks of
tests/test_multihost.py's worker, and writes what it saw to
OUT_DIR/rank{RANK}.pt for the tests to hold against the single-device
port and the JAX package.
"""
import copy
import random
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from bgn_torch import encoding, polyct, scheme  # noqa: E402
from bgn_torch.config import BGNParams  # noqa: E402
from bgn_torch.fieldcore import limbs as lb  # noqa: E402
from bgn_torch.fieldcore import montgomery as mg  # noqa: E402
from bgn_torch.parallel import make_mesh, replicate  # noqa: E402
from bgn_torch.parallel.mesh import shard_poly_ciphertext  # noqa: E402
from bgn_torch.parallel import multihost as mh  # noqa: E402
from bgn_torch.parallel import pipeline as pp  # noqa: E402
from bgn_torch.parallel import sharded as sh  # noqa: E402
from bgn_torch.parallel.mesh import axis_size  # noqa: E402

# the lanes of the session, shared with the tests (which import them)
DP_A, DP_B = list(range(8)), [3] * 8
GT_MS = [0, 1, 12, 900, 33, 50]
GT_KS = [1, 5, 1, 1, 31, 50]       # m*k: 0 ... 1023, and 2500 (out of range)
G1_MS = [0, 1, 12, 900, -33, -1000, 1023, 2500]
PIPE_MS = [0, 1, 2, 7, 100, 55, 13, 9]
PIPE_KS = [1, 3, 5, 2, 99, 4, 8, 6]
POLY_VALUES = [100.1, 2.5, 2.5, 100.1]   # one scale factor
SEED = 5                           # keygen(64, 1021, Random(SEED)) + tables


def keys():
    rng = random.Random(SEED)
    pk, sk = scheme.keygen(64, 1021, rng=rng, device="cpu")
    return pk, sk, pk.setup_decryption(sk, rng=rng)


def randomness(pk, count, seed):
    rng = random.Random(seed)
    return [rng.randrange(pk.n) for _ in range(count)]


def gt_lanes(pk):
    """L2 lanes m*k (incl. 0 and one out of range) and their negatives."""
    prod = pk.mult(pk.encrypt_with_randomness(GT_MS, randomness(pk, 6, 21)),
                   pk.encrypt_with_randomness(GT_KS, randomness(pk, 6, 22)))
    return prod, pk.neg(prod)


def g1_lanes(pk):
    return pk.encrypt_with_randomness(G1_MS, randomness(pk, 8, 23))


def pipe_inputs(pk):
    return (pk.encrypt_with_randomness(PIPE_MS, randomness(pk, 8, 17)),
            pk.encrypt_with_randomness(PIPE_KS, randomness(pk, 8, 18)))


def _gather(t, mesh):
    parts = [None] * axis_size(mesh, "data")
    torch.distributed.all_gather_object(parts, t, group=mesh.get_group("data"))
    return parts


def _ct_tensors(ct):
    return ct.data if ct.level2 else tuple(ct.data)


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init, out_dir = sys.argv[3], sys.argv[4]
    mh.initialize(f"file://{init}", world, rank, device="cpu")
    res = {"process_info": mh.process_info()}

    # BGNParams.make_mesh: the group's ranks, n_devices within it, or None
    res["params_mesh"] = axis_size(BGNParams().make_mesh(), "data")
    res["params_mesh_one"] = BGNParams(n_devices=1).make_mesh()
    try:
        BGNParams(n_devices=world + 1).make_mesh()
        res["params_mesh_over"] = "no error"
    except ValueError as e:
        res["params_mesh_over"] = str(e)

    pk, sk, tables = keys()
    mesh = make_mesh()

    # data-parallel ops on the local rows
    a = sh.encrypt_sharded(pk, DP_A, mesh, rng=random.Random(11))
    b = sh.encrypt_sharded(pk, DP_B, mesh, rng=random.Random(12))
    s = pk.add(a, b)
    prod = sh.mult_sharded(pk, a, b, mesh)
    res["dp_local"] = [_ct_tensors(c) for c in (a, b, s, prod)]
    res["dp_gathered"] = _gather(res["dp_local"], mesh)
    res["dp_decrypt"] = _gather([sk.decrypt_with_status(c, pk, tables)
                                 for c in (s, prod)], mesh)
    # a (degree, B) poly batch: this rank's polys, their coefficients whole
    pct = polyct.encrypt_poly_batch(pk, [encoding.new_poly_plaintext(pk, v)
                                         for v in POLY_VALUES],
                                    rng=random.Random(13))
    res["poly_local"] = _ct_tensors(shard_poly_ciphertext(pct, mesh).ct)

    # replicate overwrites a zeroed copy of the key on every rank but 0
    dev2 = copy.deepcopy(pk.dev)
    if rank:
        for t in dev2.buffers():
            t.zero_()
    replicate(dev2, mesh)
    res["replicate"] = all(torch.equal(x, y) for x, y in
                           zip(dev2.buffers(), pk.dev.buffers()))

    # giant-step-sharded decrypts, RNS route then limb route
    l2, l2neg = gt_lanes(pk)
    l1 = g1_lanes(pk)
    res["bound"] = tables.bound
    res["chunk"] = sh._device_chunk(tables.bound, world)
    for route, miller in (("rns", "auto"), ("limb", "0")):
        BGNParams(rns_miller=miller).apply_kernel_modes()
        try:
            res[f"gt_{route}"] = [sh.decrypt_gt_sharded(pk, sk, tables, c,
                                                        mesh)
                                  for c in (l2, l2neg)]
            res[f"g1_{route}"] = sh.decrypt_g1_sharded(pk, sk, tables, l1,
                                                       mesh)
        finally:
            BGNParams(rns_miller="auto").apply_kernel_modes()

    # the stage pipeline: S = world stages, 8 // S microbatches
    pa, pb = pipe_inputs(pk)
    smesh = make_mesh(world, pp.STAGE_AXIS)
    res["pipeline"] = pp.pairing_pipeline(pk.dev, pa.data, pb.data, smesh,
                                          8 // world)

    # the multihost checks of tests/test_multihost.py's worker
    gmesh = mh.make_global_mesh()
    res["global_mesh"] = gmesh.size()
    try:
        mh.make_global_mesh((world + 1,))
        res["global_mesh_bad"] = "no error"
    except ValueError as e:
        res["global_mesh_bad"] = str(e)
    local = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 100.0 * rank
    g = mh.global_array_from_local(gmesh, local)
    res["global_shape"] = tuple(g.shape)
    tot = local.sum().reshape(1)
    torch.distributed.all_reduce(tot)
    res["sum"] = float(tot)
    res["local_values"] = torch.equal(mh.local_values(g * 2.0), local * 2.0)
    p = (1 << 61) - 1
    ctx = mg.make_mont_ctx(p, device="cpu")
    nrng = np.random.default_rng(7)
    xs = [int(v) for v in nrng.integers(1, p, size=4)]
    ys = [int(v) for v in nrng.integers(1, p, size=4)]
    R = 1 << (16 * ctx.L)
    gx = mh.global_array_from_local(gmesh, torch.as_tensor(
        lb.ints_to_limbs([x * R % p for x in xs], ctx.L)), batch_axis_pos=1)
    gy = mh.global_array_from_local(gmesh, torch.as_tensor(
        lb.ints_to_limbs([y * R % p for y in ys], ctx.L)), batch_axis_pos=1)
    got = mg.from_mont(ctx, mg.mont_mul(ctx, mh.local_values(gx, 1),
                                        mh.local_values(gy, 1)))
    res["mont"] = lb.limbs_to_ints(got) == [x * y % p
                                           for x, y in zip(xs, ys)]
    mine = l1[2 * rank:2 * rank + 2]
    res["global_ct"] = _ct_tensors(mh.global_ciphertext_from_local(
        pk, gmesh, mine))
    try:
        mh.global_ciphertext_from_local(pk, gmesh, mine if rank else l2)
        res["global_ct_bad"] = "no error"
    except ValueError as e:
        res["global_ct_bad"] = str(e)

    torch.save(res, f"{out_dir}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
