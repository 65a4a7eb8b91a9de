"""The port's parallel layer (bgn_torch/parallel/) on the CPU, against the
single-device port and the JAX package (bgn_tpu/parallel/).

Each world size runs in ONE spawned gloo session (2 ranks, then 4, at
the same time; tests/_torch_parallel_worker.py, which imports no JAX,
through a file:// store); the tests read what every rank saw.  The JAX
side runs only where parity is the point: decrypt_gt_sharded on its
8-device CPU mesh and the 2-stage pairing_pipeline, on the same
ciphertexts built from the port's limbs through hostmath.
"""
import _torch_threads  # noqa: F401  (first: one torch thread per process)
import os
import random
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_parallel_worker as w
from bgn_torch import encoding as tencoding
from bgn_torch import hostmath as thm
from bgn_torch import polyct as tpolyct
from bgn_torch.ops import rns_pairing as trp
from bgn_torch.parallel import pipeline as tpp
from bgn_torch.parallel import sharded as tsh
from bgn_torch.utils import convert as tconvert
from bgn_tpu import scheme as jscheme
from bgn_tpu.parallel import make_mesh as jmake_mesh
from bgn_tpu.parallel import pipeline as jpp
from bgn_tpu.parallel import sharded as jsh
from bgn_tpu.utils import convert as jconvert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)


def _start(world, tmp):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = tmp / f"world{world}"
    out.mkdir()
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_parallel_worker.py"),
         str(r), str(world), str(out / "store"), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for r in range(world)], out


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} of one session per world
    size; a rank that fails stops its session at once."""
    tmp = tmp_path_factory.mktemp("gloo")
    started = {n: _start(n, tmp) for n in WORLDS}
    procs = [p for ps, _ in started.values() for p in ps]
    deadline = time.time() + 600
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    failed = [(p.args[2:4], p.communicate()[0][-3000:]) for p in procs
              if p.wait() != 0]
    assert not failed, failed
    return {n: [torch.load(out / f"rank{r}.pt", weights_only=False)
                for r in range(n)] for n, (_, out) in started.items()}


@pytest.fixture(scope="module")
def port():
    """The sessions' key on one device, and the single-device results."""
    pk, sk, tables = w.keys()
    l2, l2neg = w.gt_lanes(pk)
    l1 = w.g1_lanes(pk)
    single = {"gt": [sk.decrypt_with_status(c, pk, tables)
                     for c in (l2, l2neg)],
              "g1": sk.decrypt_with_status(l1, pk, tables)}
    return pk, sk, tables, (l2, l2neg, l1), single


def _same_found_and_values(got, want):
    (m1, f1), (m2, f2) = got, want
    assert list(f1) == list(f2)
    # the value of a lane not found is unspecified (the reference raises
    # there, bgn.go:205-207)
    assert list(m1[f1]) == list(m2[f2])


@pytest.mark.parametrize("world", WORLDS)
def test_session_start_up_and_meshes(sessions, world):
    for rank, res in enumerate(sessions[world]):
        assert res["process_info"] == (rank, world)
        assert res["params_mesh"] == world
        assert res["params_mesh_one"] is None
        assert f"n_devices={world + 1}" in res["params_mesh_over"]
        assert res["global_mesh"] == world
        assert "global ranks" in res["global_mesh_bad"]


@pytest.mark.parametrize("world", WORLDS)
def test_dp_ops_equal_unsharded(sessions, port, world):
    """Encrypt / Add / Mult on the local rows, all-gathered, equal the
    unsharded ops limb for limb; the local rows decrypt to m + 3, 3m; a
    poly batch is cut along its poly axis."""
    pk, sk, tables, _, _ = port
    a = pk.encrypt(w.DP_A, rng=random.Random(11))
    b = pk.encrypt(w.DP_B, rng=random.Random(12))
    want = [a, b, pk.add(a, b), pk.mult(a, b)]
    for res in sessions[world]:
        for i, c in enumerate(want):
            parts = [g[i] for g in res["dp_gathered"]]
            if c.level2:
                got = torch.cat(parts, dim=-1)
                assert torch.equal(got, c.data), i
            else:
                for f, t in enumerate(c.data):
                    got = torch.cat([p[f] for p in parts], dim=-1)
                    assert torch.equal(got, t), (i, f)
        pct = tpolyct.encrypt_poly_batch(pk, [
            tencoding.new_poly_plaintext(pk, v) for v in w.POLY_VALUES],
            rng=random.Random(13))
        cut = len(w.POLY_VALUES) // world       # each rank's polys
        r = sessions[world].index(res)
        for t, full in zip(res["poly_local"], pct.ct.data):
            assert torch.equal(t, full[..., r * cut:(r + 1) * cut])
        for i, want_m in enumerate(([m + 3 for m in w.DP_A],
                                    [3 * m for m in w.DP_A])):
            vals = np.concatenate([d[i][0] for d in res["dp_decrypt"]])
            ok = np.concatenate([d[i][1] for d in res["dp_decrypt"]])
            assert ok.all() and list(vals) == want_m


@pytest.mark.parametrize("world", WORLDS)
def test_replicate_overwrites_zeroed_copy(sessions, world):
    assert all(res["replicate"] for res in sessions[world])


@pytest.mark.parametrize("route", ["rns", "limb"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_decrypt_equals_single_device(sessions, port, world, route):
    """Both groups, 0, negatives and an out-of-range lane (found False),
    every rank: (m, found) of the single-device decrypt_with_status."""
    single = port[4]
    for res in sessions[world]:
        for got, want in zip(res[f"gt_{route}"], single["gt"]):
            _same_found_and_values(got, want)
        _same_found_and_values(res[f"g1_{route}"], single["g1"])
        assert list(res[f"g1_{route}"][0]) == w.G1_MS[:-1] + [0]


@pytest.mark.parametrize("world", WORLDS)
def test_last_chunk_runs_past_bound(sessions, world):
    """At msg space 1021 (bound 32, 33 giant steps) the last rank's chunk
    ends past the bound, so its range mask is exercised."""
    res = sessions[world][0]
    assert res["bound"] == 32
    assert res["chunk"] == tsh._device_chunk(32, world)
    assert res["chunk"] * world > res["bound"] + 1
    assert (world - 1) * res["chunk"] <= res["bound"]


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_equals_pairing_rns(sessions, port, world):
    """(stages, microbatches) = (2, 4) and (4, 2): every rank returns the
    limbs of pairing_rns over the bits of n."""
    pk = port[0]
    a, b = w.pipe_inputs(pk)
    want = trp.pairing_rns(pk.dev.ctx, pk.dev.rns, a.data, b.data,
                           pk.dev.n_bits, pk.dev.l_bits)
    for res in sessions[world]:
        assert torch.equal(res["pipeline"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_multihost_checks(sessions, port, world):
    """process_info, a global mesh, an all_reduce sum, a Montgomery
    product on the local rows, local_values, and the local ciphertext rows
    (the check that every rank's rows agree beyond the batch axis)."""
    l1 = port[3][2]
    want_sum = sum(float(np.sum(np.arange(8) + 100.0 * q))
                   for q in range(world))
    for rank, res in enumerate(sessions[world]):
        assert res["global_shape"] == (4 * world, 2)
        assert res["sum"] == want_sum
        assert res["local_values"] and res["mont"]
        for t, want in zip(res["global_ct"], l1.data):
            assert torch.equal(t, want[..., 2 * rank:2 * rank + 2])
        assert "differ beyond the batch axis" in res["global_ct_bad"]


@pytest.mark.parametrize("case", [(0b1011011101111, 16, 4, 128),
                                  (0b0001011011101111, 16, 2, 96),
                                  (None, 64, 1, 96), (None, 64, 2, 96),
                                  (None, 64, 4, 96), (None, 512, 3, 544)])
def test_plan_segments_match_jax(port, case):
    n, nbits, stages, pbits = case
    if n is None:
        n = port[0].n if nbits == 64 else random.Random(3).getrandbits(511)
    np.testing.assert_array_equal(tpp.plan_segments(n, nbits, stages, pbits),
                                  jpp.plan_segments(n, nbits, stages, pbits))


def _jax_l2(jpk, pk, ct):
    return jscheme.Ciphertext(jconvert.fp2_from_host(
        jpk.dev.ctx, tconvert.fp2_to_host(pk.dev.ctx, ct.data)), True)


def test_sharded_decrypt_equals_jax(sessions, port, shared_keypair):
    """The JAX package's decrypt_gt_sharded on its 8-device mesh, on the
    same L2 lanes: every rank's (m, found) of both routes equals it."""
    jpk, jsk, jtables = shared_keypair
    pk, _, _, (l2, l2neg, _), _ = port
    assert (jpk.n, jpk.P_host) == (pk.n, pk.P_host)
    mesh = jmake_mesh()
    for i, ct in enumerate((l2, l2neg)):
        want = jsh.decrypt_gt_sharded(jpk, jsk, jtables, _jax_l2(jpk, pk, ct),
                                      mesh)
        for world in WORLDS:
            for res in sessions[world]:
                for route in ("rns", "limb"):
                    _same_found_and_values(res[f"gt_{route}"][i], want)


def test_pipeline_equals_jax(sessions, port, shared_keypair):
    """The JAX package's 2-stage pairing_pipeline (4 microbatches) on the
    same points gives the 2-rank session's limbs."""
    jpk = shared_keypair[0]
    pk = port[0]
    gk = thm.GoldenKey(params=port[1].a1_params, P=pk.P_host, Q=pk.Q_host,
                       R=port[1].r, msg_space=pk.msg_space)
    pts = [[thm.golden_encrypt(gk, m, r) for m, r in zip(ms, w.randomness(
        pk, 8, seed))] for ms, seed in ((w.PIPE_MS, 17), (w.PIPE_KS, 18))]
    ja, jb = (jconvert.affine_from_host(jpk.dev.ctx, p) for p in pts)
    mesh = Mesh(np.asarray(jax.devices()[:2]), (jpp.STAGE_AXIS,))
    z = np.asarray(jpp.pairing_pipeline(jpk.dev, ja, jb, mesh, 4))
    for res in sessions[2]:
        np.testing.assert_array_equal(res["pipeline"].numpy(), z)
