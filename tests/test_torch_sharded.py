"""The sharded pod path of fleetflow_tpu_torch (solver/sharded.py) against
fleetflow_tpu.solver.sharded on the CPU.

The reference runs on the 8-device virtual CPU mesh tests/conftest.py sets
up; the port on meshes whose positions all name the CPU (its one-device
mesh: the shards are K7's thread blocks on the card, the plain version
here). The sweep cannot match by seed (torch's generator is not
threefry), so the port's draws come through its one seam, a draw object:
:class:`JaxDraws` reproduces the reference's cumulative key schedule
(fold_in of the sweep index carried from sweep to sweep, then of the shard
and, on a mesh with a replica axis, of the replica; split into four;
categorical over the shard's hot services) and the exchange's uniforms
(fold_in(key, 0x7357), then the replica), from the port's own hot mask.

Tolerances. Given the same draws: assignments, sweeps, swap counters and
the violation parts are equal. The reference's psum sums the shards'
partial load deltas in device order, which K7's reduction and the plain
version repeat, so a sweep's load update is bit-equal; the initial
replica state and the winner's stats come from a K3 rebuild (service
order) where the reference sums per shard and then psums, so loads (and
the soft scores read from them) differ by float32 rounding only: soft
within rel 1e-5. The merge and the delta-versus-cold staging are
bit-equal. End to end, solve_sharded is held to the contract: 0
violations, nothing on a dead node, and a moved fraction within 5 points
of the reference's from the same seed assignment.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from fleetflow_tpu.lower.tensors import synthetic_problem as ref_synthetic
from fleetflow_tpu.solver import problem as ref_problem
from fleetflow_tpu.solver import sharded as ref_sh
from fleetflow_tpu.solver.resident import ProblemDelta as RefDelta
from fleetflow_tpu_torch.convert import sharded_from_reference
from fleetflow_tpu_torch.core.errors import SolverError
from fleetflow_tpu_torch.entry import dryrun_multichip
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.solver import problem as port_problem
from fleetflow_tpu_torch.solver import sharded as sh
from fleetflow_tpu_torch.solver.buckets import pad_problem as port_pad
from fleetflow_tpu_torch.solver.repair import verify
from fleetflow_tpu_torch.solver.resident import ProblemDelta
from test_torch_problem import ref_arrays, staged_pair, to_np

CPU8 = ["cpu"] * 8
SOFT_RTOL = 1e-5


def _need_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices, have {len(jax.devices())}")


@partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_draw(key, hot, N, M, has_rep):
    """Every position's proposals as the reference's sweep draws them."""
    R, D, S_loc = hot.shape

    def one(rep, me, hot_rd):
        kk = jax.random.fold_in(key, me)
        if has_rep:
            kk = jax.random.fold_in(kk, rep)
        ks, kb, ka, kt = jax.random.split(kk, 4)
        logits = jnp.where(hot_rd, 0.0, -30.0)
        s_tgt = jax.random.categorical(kt, logits, shape=(M,))
        s_uni = jax.random.randint(ks, (M,), 0, S_loc)
        s_idx = jnp.where(jnp.arange(M) < M // 2, s_tgt, s_uni)
        return (s_idx, jax.random.randint(kb, (M,), 0, N),
                jax.random.uniform(ka, (M,)))

    reps = jnp.arange(R, dtype=jnp.int32)
    shards = jnp.arange(D, dtype=jnp.int32)
    return jax.vmap(lambda rep, h: jax.vmap(
        lambda me, hh: one(rep, me, hh))(shards, h))(reps, hot)


class JaxDraws:
    """The reference's draws, through the port's draw seam."""

    def __init__(self, key, has_rep: bool):
        self.key, self.has_rep = key, has_rep

    def proposals(self, sweep, hot, N, M):
        self.key = jax.random.fold_in(self.key, jnp.int32(sweep))
        out = _jax_draw(self.key, jnp.asarray(to_np(hot)), N, M,
                        self.has_rep)
        s, b, u = (np.asarray(x) for x in out)
        return (torch.tensor(s.astype(np.int32)),
                torch.tensor(b.astype(np.int32)), torch.tensor(u))

    def exchange(self, R, device):
        kx = jax.random.fold_in(self.key, jnp.int32(0x7357))
        return torch.tensor(np.array(
            [np.asarray(jax.random.uniform(jax.random.fold_in(
                kx, jnp.int32(r)))) for r in range(R)], dtype=np.float32))


def _meshes(layout):
    """(reference mesh, port mesh, shards) of a layout name."""
    if layout == "1x8":
        return (JaxMesh(np.array(jax.devices()[:8]), (ref_sh.SVC_AXIS,)),
                sh.Mesh(CPU8, (sh.SVC_AXIS,)), 8)
    R, D = {"t1x8": (1, 8), "t2x4": (2, 4)}[layout]
    return (ref_sh.tempering_mesh(R, D),
            sh.tempering_mesh(R, D, devices=CPU8), D)


# (layout, S, N, seed, adaptive, block, exchange_every, steps, packed,
#  extras): the 1x8 mesh without a replica axis (fixed and adaptive), the
# 2x4 tempering mesh (exchange every block and every other), the 1x8
# tempering mesh; ragged S (phantoms), packed and dense, a preference
# plane, strategies 0, 1 and 2, a spread constraint
ANNEAL_CASES = [
    ("1x8", 128, 16, 2, False, 4, 1, 24, True, {}),
    ("1x8", 61, 8, 3, True, 4, 1, 32, True, {}),
    ("1x8", 96, 12, 4, False, 4, 1, 16, False,
     dict(strategy="pack_into_dedicated", preferred=True)),
    ("1x8", 100, 10, 12, True, 8, 1, 32, True,
     dict(strategy="fill_lowest", max_skew=4, domains=2, coloc=True)),
    ("t2x4", 73, 12, 1, False, 4, 1, 16, True, {}),
    ("t2x4", 73, 12, 1, False, 4, 2, 16, True, {}),
    ("t2x4", 80, 12, 5, True, 4, 1, 24, False,
     dict(strategy="fill_lowest", preferred=True, coloc=True)),
    ("t1x8", 73, 12, 1, True, 4, 1, 16, True,
     dict(strategy="pack_into_dedicated")),
]


def _anneal_pair(layout, S, N, seed, adaptive, block, exchange_every, steps,
                 packed, extras, init_kind="zeros"):
    _need_devices(8)
    ref_mesh, port_mesh, D = _meshes(layout)
    dp, tp, _, _ = staged_pair(S, N, seed, packed=packed, **extras)
    dpp, orig = ref_sh.pad_problem(dp, D)
    tpp, _ = port_pad(tp, D)
    init = np.zeros(dpp.S, np.int32)
    if init_kind == "random":
        init = np.random.default_rng(seed).integers(0, N, dpp.S).astype(
            np.int32)
    key = jax.random.PRNGKey(seed)
    kw = dict(steps=steps, mesh=ref_mesh, adaptive=adaptive, block=block,
              n_real=orig, exchange_every=exchange_every, return_stats=True,
              trace_blocks=8)
    ref = ref_sh.anneal_sharded(dpp, jnp.asarray(init), key, **kw)
    kw["mesh"] = port_mesh
    port = sh.anneal_sharded(
        tpp, torch.tensor(init), draws=JaxDraws(
            key, sh.REPLICA_AXIS in port_mesh.shape), **kw)
    return ref, port, (dp, dpp, tpp, orig, init, key, D)


def _check_stats(ref, port):
    assert np.array_equal(np.asarray(ref.assignment), to_np(port.assignment))
    assert int(ref.sweeps) == port.sweeps
    assert int(ref.swap_attempts) == port.swap_attempts
    assert int(ref.swap_accepts) == int(port.swap_accepts)
    for part in ("capacity", "conflicts", "eligibility", "skew"):
        assert float(getattr(ref, part)) == float(getattr(port, part)), part
    np.testing.assert_allclose(float(port.soft), float(ref.soft),
                               rtol=SOFT_RTOL)
    rt, pt_ = np.asarray(ref.telemetry), to_np(port.telemetry)
    assert rt.shape == pt_.shape
    for col in (0, 2, 4, 5):    # sweeps, best violations, swap counters
        assert np.array_equal(rt[:, col], pt_[:, col]), col
    np.testing.assert_allclose(pt_[:, 1], rt[:, 1], rtol=1e-6)
    np.testing.assert_allclose(pt_[:, 3], rt[:, 3], rtol=SOFT_RTOL)


class TestAnnealParity:
    @pytest.mark.parametrize("case", ANNEAL_CASES,
                             ids=[f"{c[0]}-{c[1]}x{c[2]}-{i}"
                                  for i, c in enumerate(ANNEAL_CASES)])
    def test_matches_reference_given_its_draws(self, case):
        ref, port, _ = _anneal_pair(*case)
        _check_stats(ref, port)

    def test_many_departures_from_one_node(self):
        """Every service starts on node 0 and the first sweeps are hot:
        each sweep moves many services off node 0 (each position's
        departures in proposal order, the shards' partials summed in shard
        order), equal to the reference given its draws."""
        ref, port, (_dp, _dpp, _tpp, orig, _init, _key, _D) = _anneal_pair(
            "1x8", 256, 40, 21, False, 4, 1, 2, True, {})
        _check_stats(ref, port)
        assert int((to_np(port.assignment)[:orig] != 0).sum()) >= 20

    def test_random_start_with_return_sweeps(self):
        """A random (infeasible) start, return_sweeps on both."""
        ref, port, ctx = _anneal_pair("t2x4", 73, 12, 7, True, 4, 1, 24,
                                      True, {}, init_kind="random")
        _check_stats(ref, port)
        dp, dpp, tpp, orig, init, key, D = ctx
        a_ref, n_ref = ref_sh.anneal_sharded(
            dpp, jnp.asarray(init), key, steps=24, mesh=_meshes("t2x4")[0],
            adaptive=True, block=4, n_real=orig, return_sweeps=True)
        a_port, n_port = sh.anneal_sharded(
            tpp, torch.tensor(init), steps=24, mesh=_meshes("t2x4")[1],
            adaptive=True, block=4, n_real=orig, return_sweeps=True,
            draws=JaxDraws(key, True))
        assert np.array_equal(np.asarray(a_ref), to_np(a_port))
        assert int(n_ref) == n_port

    def test_state_carrier_starts_both_from_one_state(self):
        """convert.sharded_from_reference: the reference's padded problem,
        per-shard assignment and replica node state become the port's;
        anneal_sharded(init_state=...) from it equals the reference's
        anneal from the same assignment."""
        _need_devices(8)
        ref_mesh, port_mesh, D = _meshes("t2x4")
        dp, _tp, _, _ = staged_pair(73, 12, 3)
        dpp, orig = ref_sh.pad_problem(dp, D)
        init = np.random.default_rng(3).integers(0, 12, dpp.S).astype(
            np.int32)
        ref_anneal = __import__("fleetflow_tpu.solver.anneal",
                                fromlist=["x"])
        dpr = dataclasses.replace(dpp, n_real=jnp.asarray(orig, jnp.int32))
        cs = ref_anneal.chain_states_from_assignment(dpr, jnp.asarray(init))
        planes = [np.stack([np.asarray(getattr(cs, f))] * 2)
                  for f in ("load", "used", "coloc", "topo")]
        arrays, statics = ref_arrays(dpp)
        prob, st = sharded_from_reference(
            arrays, statics, np.stack([init.reshape(D, -1)] * 2), *planes,
            device="cpu")
        assert st.assignment.shape == (2, dpp.S) and prob.S == dpp.S
        key = jax.random.PRNGKey(3)
        ref = ref_sh.anneal_sharded(dpp, jnp.asarray(init), key, steps=12,
                                    mesh=ref_mesh, block=4, n_real=orig,
                                    return_stats=True)
        port = sh.anneal_sharded(prob, None, steps=12, mesh=port_mesh,
                                 block=4, n_real=orig, return_stats=True,
                                 draws=JaxDraws(key, True), init_state=st)
        assert np.array_equal(np.asarray(ref.assignment),
                              to_np(port.assignment))
        assert int(ref.swap_accepts) == int(port.swap_accepts)
        with pytest.raises(ValueError):
            sharded_from_reference(arrays, statics, init[:-1], *planes,
                                   device="cpu")


class TestStep:
    @pytest.mark.parametrize("layout", [(1, 8), (2, 4)])
    def test_winner_rules_and_planes(self, layout):
        """One plain sweep from a hot random state: at most one arrival a
        node a replica, one move a service, and the carried planes equal
        a K3 rebuild of the new assignments (integers exactly, the load
        within float32 rounding)."""
        R, D = layout
        _dp, tp, _, _ = staged_pair(200, 16, 8, coloc=True, max_skew=3,
                                    domains=4)
        rng = np.random.default_rng(8)
        a0 = torch.tensor(rng.integers(0, 16, (R, 200)), dtype=torch.int32)
        st = sh.chain_states_from_assignment(tp, a0)
        gen = torch.Generator().manual_seed(8)
        hot = sh._hot(tp, st, D)
        s_loc, b_idx, u = sh.TorchDraws(gen).proposals(0, hot, 16, 25)
        _, applied = sh.sharded_step_plain(tp, st, s_loc, b_idx, u,
                                           [5.0] * R)
        moved = st.assignment != a0
        assert int(applied.sum()) == int(moved.sum()) > 0
        for r in range(R):
            arrivals = torch.bincount(st.assignment[r][moved[r]].long(),
                                      minlength=16)
            assert int(arrivals.max()) <= 1
        fresh = sh.chain_states_from_assignment(tp, st.assignment)
        for f in ("used", "coloc", "topo"):
            assert torch.equal(getattr(st, f), getattr(fresh, f)), f
        torch.testing.assert_close(st.load, fresh.load, rtol=1e-5,
                                   atol=1e-5)

    def test_wrappers_raise_on_bad_input(self):
        _dp, tp, _, _ = staged_pair(64, 8, 0)
        st = sh.chain_states_from_assignment(
            tp, torch.zeros((1, 64), dtype=torch.int32))
        s = torch.zeros((1, 8, 4), dtype=torch.int32)
        u = torch.zeros((1, 8, 4))
        with pytest.raises(ValueError):
            sh.sharded_step_apply(tp, st, s, s, u, [1.0, 1.0])
        with pytest.raises(ValueError):
            sh.sharded_step_apply(tp, st, s[:, :7], s[:, :7], u[:, :7],
                                  [1.0])
        with pytest.raises(ValueError):
            sh.sharded_step_apply(tp, st, s.long(), s, u, [1.0])


class TestMesh:
    @pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2), (8, 1),
                                       (2, None), (3, None)])
    def test_tempering_mesh_shapes_match_reference(self, shape):
        _need_devices(8)
        ref = ref_sh.tempering_mesh(*shape)
        port = sh.tempering_mesh(*shape, devices=CPU8)
        assert dict(ref.shape) == port.shape
        assert port.device == torch.device("cpu")

    def test_too_few_positions_raise(self):
        with pytest.raises(ValueError):
            sh.tempering_mesh(2, 8, devices=CPU8)
        with pytest.raises(ValueError):
            ref_sh.tempering_mesh(2, 8, devices=jax.devices()[:8])

    def test_distinct_devices_raise(self):
        with pytest.raises(SolverError, match="multi-card sharded path"):
            sh.Mesh(["cuda:0", "cuda:1"], (sh.SVC_AXIS,))
        with pytest.raises(SolverError):
            sh.tempering_mesh(2, 1, devices=["cpu", "cuda:0"])
        assert sh.Mesh(CPU8, (sh.SVC_AXIS,)) == sh.Mesh(
            [torch.device("cpu")] * 8, (sh.SVC_AXIS,))
        assert sh.Mesh(CPU8, (sh.SVC_AXIS,)) != sh.tempering_mesh(
            1, 8, devices=CPU8)

    def test_swap_criterion_matches_reference(self):
        rng = np.random.default_rng(0)
        e_a, e_b = (rng.normal(100, 10, 4096).astype(np.float32)
                    for _ in range(2))
        u = rng.uniform(0, 1, 4096).astype(np.float32)
        for b_a, b_b in ((2.0, 0.5), (1.5, 1.5), (50.0, 0.02)):
            ref = np.asarray(ref_sh.tempering_swap_accept(
                jnp.asarray(e_a), jnp.asarray(e_b), jnp.float32(b_a),
                jnp.float32(b_b), jnp.asarray(u)))
            port = sh.tempering_swap_accept(
                torch.tensor(e_a), torch.tensor(e_b),
                torch.tensor(b_a, dtype=torch.float32),
                torch.tensor(b_b, dtype=torch.float32), torch.tensor(u))
            assert np.array_equal(ref, to_np(port))
        assert bool(sh.tempering_swap_accept(
            torch.tensor(e_a), torch.tensor(e_b), 1.5, 1.5,
            torch.tensor(u)).all())


def _ref_staged_sharded(pt, D, mesh):
    dp = ref_problem.prepare_problem(pt)
    padded, _ = ref_sh.pad_problem(dp, D)
    return ref_sh.shard_problem(padded, mesh)


class TestBytes:
    @pytest.mark.parametrize("packed", [True, False])
    @pytest.mark.parametrize("D", [1, 2, 4, 8])
    def test_per_device_bytes_matches_reference(self, packed, D):
        _need_devices(8)
        dp, tp, _, _ = staged_pair(250, 40, 3, packed=packed,
                                   preferred=not packed, coloc=True)
        ref_mesh = JaxMesh(np.array(jax.devices()[:D]), (ref_sh.SVC_AXIS,))
        port_mesh = sh.Mesh(["cpu"] * D, (sh.SVC_AXIS,))
        dpp, _ = ref_sh.pad_problem(dp, D)
        tpp, _ = port_pad(tp, D)
        placed = ref_sh.shard_problem(dpp, ref_mesh)
        for state in (False, True):
            assert sh.per_device_bytes(tpp, port_mesh, state=state) == \
                ref_sh.per_device_bytes(placed, state=state)
        assert sh.shard_problem(tpp, port_mesh) is tpp


def _churn_values(pt, rng):
    """One churn event (the reference test's family): a validity flip, a
    capacity drift and a demand drift on three rows, as plain arrays."""
    valid = pt.node_valid.copy()
    j = int(rng.integers(0, pt.N))
    valid[j] = ~valid[j]
    if not valid.any():
        valid[j] = True
    cap = pt.capacity.copy()
    cap[int(rng.integers(0, pt.N))] *= float(rng.uniform(0.9, 1.2))
    rows = rng.choice(pt.S, size=3, replace=False).astype(np.int32)
    dem = pt.demand.copy()
    dem[rows] = (dem[rows] * rng.uniform(0.5, 1.5)).astype(dem.dtype)
    return valid, cap, rows, dem


def _churn(pt, values, delta_cls):
    valid, cap, rows, dem = values
    nxt = dataclasses.replace(pt, node_valid=valid, capacity=cap, demand=dem)
    return nxt, delta_cls(node_valid=valid, capacity=cap,
                          demand_rows=(rows, dem[rows]))


STEPS = 16


class TestMerge:
    @pytest.mark.parametrize("packed", [True, False])
    @pytest.mark.parametrize("arrivals", [False, True])
    def test_merge_bit_equal_to_reference(self, packed, arrivals):
        """merge_sharded against _merge_fn_sharded on the same padded
        staging and assignment: demand and eligibility rows, node planes,
        n_real and the phantom re-park."""
        _need_devices(8)
        S, N, D = 70, 12, 8
        dp, tp, ref_pt, _ = staged_pair(S, N, 5, packed=packed)
        dpp, orig = ref_sh.pad_problem(dp, D)
        tpp, _ = port_pad(tp, D)
        mesh = JaxMesh(np.array(jax.devices()[:D]), (ref_sh.SVC_AXIS,))
        dpp = ref_sh.shard_problem(
            dataclasses.replace(dpp, n_real=jnp.asarray(orig, jnp.int32)),
            mesh)
        tpp.n_real = orig
        rng = np.random.default_rng(5)
        assign = rng.integers(0, N, dpp.S).astype(np.int32)
        valid = ref_pt.node_valid.copy()
        valid[:3] = False
        cap = (ref_pt.capacity * 1.1).astype(np.float32)
        rows = np.array([1, 9, 40], np.int32)
        dem_val = rng.random((3, 3)).astype(np.float32)
        masks = rng.random((3, N)) < 0.5
        n_real = orig
        if arrivals:
            rows = np.concatenate([rows, [orig, orig + 1]]).astype(np.int32)
            dem_val = rng.random((5, 3)).astype(np.float32)
            masks = rng.random((5, N)) < 0.5
            n_real = orig + 2
        words = (ref_problem.pack_bool_rows(masks) if packed else masks)
        pad = 8 - rows.shape[0]      # the reference's row tier, drop slots
        r_idx = np.concatenate([rows, np.full(pad, dpp.S, np.int32)])
        r_dem = np.concatenate([dem_val, np.zeros((pad, 3), np.float32)])
        r_el = np.concatenate([words, np.zeros((pad,) + words.shape[1:],
                                               words.dtype)])
        ref_prob, ref_a = ref_sh._merge_fn_sharded(mesh)(
            dpp, jnp.asarray(assign), jnp.asarray(valid), jnp.asarray(cap),
            jnp.asarray(r_idx), jnp.asarray(r_dem), jnp.asarray(r_idx),
            jnp.asarray(r_el), jnp.asarray(n_real, jnp.int32),
            has_demand=True, has_eligible=True)
        port_a = torch.tensor(assign)
        el = (torch.tensor(port_problem.pack_bool_rows(masks))
              if packed else torch.tensor(masks))
        sh.merge_sharded(tpp, port_a, torch.tensor(valid), torch.tensor(cap),
                         (torch.tensor(rows).long(), torch.tensor(dem_val)),
                         (torch.tensor(rows).long(), el), n_real,
                         first_valid=int(np.argmax(valid)))
        assert np.array_equal(np.asarray(ref_a), to_np(port_a))
        for name in ("demand", "capacity", "eligible", "node_valid"):
            r = np.asarray(getattr(ref_prob, name))
            if r.dtype == np.uint32:
                r = r.view(np.int32)
            assert np.array_equal(r, to_np(getattr(tpp, name))), name
        assert int(ref_prob.n_real) == tpp.n_real == n_real


class TestShardedResident:
    @pytest.mark.parametrize("seed", range(3))
    def test_churn_sequence_equivalence(self, seed):
        """A churn sequence applied through deltas equals a cold
        restaging seeded with the same previous assignment, bit for bit:
        the padded tensors and the solves."""
        rng = np.random.default_rng(seed)
        pt = synthetic_problem(73, 12, seed=seed, port_fraction=0.3,
                               volume_fraction=0.2)
        mesh = sh.tempering_mesh(2, 4, devices=CPU8)
        rp = sh.ShardedResident(pt, mesh=mesh)
        assert rp.prob.S % 4 == 0 and rp.mesh == mesh
        prev_cold = sh.solve_sharded(pt, resident=rp, steps=STEPS,
                                     seed=seed).assignment
        for step in range(3):
            pt, delta = _churn(pt, _churn_values(pt, rng), ProblemDelta)
            assert rp.compatible(pt, delta)
            rp.apply_delta(pt, delta)
            a = sh.solve_sharded(pt, resident=rp, resident_warm=True,
                                 steps=STEPS, seed=100 + step)
            rp2 = sh.ShardedResident(pt, mesh=mesh)
            rp2.adopt_host(prev_cold, pt.node_valid, warm=False)
            b = sh.solve_sharded(pt, resident=rp2, resident_warm=True,
                                 steps=STEPS, seed=100 + step)
            prev_cold = b.assignment
            assert np.array_equal(a.assignment, b.assignment), step
            for name, x, y in zip(port_problem.TENSOR_FIELDS,
                                  rp.prob.tensors(), rp2.prob.tensors()):
                assert (x is None) == (y is None), name
                if x is not None:
                    assert torch.equal(x, y), (name, step)
            assert rp.prob.n_real == pt.S
            assert verify(pt, a.assignment)["total"] == a.stats["total"]

    @pytest.mark.parametrize("packed", [True, False])
    def test_staging_and_merges_equal_reference(self, packed, monkeypatch):
        """The port's sharded staging after each delta merge equals the
        reference ShardedResident's, tensor for tensor."""
        _need_devices(8)
        monkeypatch.setenv("FLEET_PACKED", "1" if packed else "0")
        rng = np.random.default_rng(9)
        ref_pt = ref_synthetic(73, 12, seed=9, port_fraction=0.3)
        pt = synthetic_problem(73, 12, seed=9, port_fraction=0.3)
        ref_rp = ref_sh.ShardedResident(ref_pt,
                                        mesh=ref_sh.tempering_mesh(2, 4))
        rp = sh.ShardedResident(pt, mesh=sh.tempering_mesh(2, 4,
                                                           devices=CPU8))
        seed = np.arange(73, dtype=np.int32) % 12
        ref_rp.adopt_host(seed, ref_pt.node_valid, warm=False)
        rp.adopt_host(seed, pt.node_valid, warm=False)
        for _ in range(3):
            values = _churn_values(pt, rng)
            ref_pt, ref_delta = _churn(ref_pt, values, RefDelta)
            pt, delta = _churn(pt, values, ProblemDelta)
            ref_rp.apply_delta(ref_pt, ref_delta)
            rp.apply_delta(pt, delta)
            assert np.array_equal(np.asarray(ref_rp.assignment),
                                  to_np(rp.assignment))
            for name in ("demand", "capacity", "conflict_ids", "coloc_ids",
                         "eligible", "node_valid", "node_topology"):
                r = np.asarray(getattr(ref_rp.prob, name))
                if r.dtype == np.uint32:
                    r = r.view(np.int32)
                assert np.array_equal(r, to_np(getattr(rp.prob, name))), name
            assert int(ref_rp.prob.n_real) == rp.prob.n_real

    @pytest.mark.parametrize("dims", [(1, 1), (2, 4)])
    def test_result_survives_later_warm_dispatches(self, dims):
        rng = np.random.default_rng(14)
        pt = synthetic_problem(73, 12, seed=14, port_fraction=0.3,
                               volume_fraction=0.2)
        rp = sh.ShardedResident(pt, mesh=sh.tempering_mesh(*dims,
                                                           devices=CPU8))
        kept = sh.solve_sharded(pt, resident=rp, steps=STEPS,
                                seed=14).assignment
        assert kept.base is None or kept.base.flags["OWNDATA"]
        pinned = kept.copy()
        for step in range(3):
            pt, delta = _churn(pt, _churn_values(pt, rng), ProblemDelta)
            rp.apply_delta(pt, delta)
            sh.solve_sharded(pt, resident=rp, resident_warm=True,
                             steps=STEPS, seed=140 + step)
        assert np.array_equal(kept, pinned)

    def test_two_lane_exchange_is_deterministic(self):
        pt = synthetic_problem(64, 10, seed=5, port_fraction=0.2)
        prob = port_problem.prepare_problem(pt, "cpu")
        mesh = sh.tempering_mesh(2, 1, devices=CPU8)
        init = torch.zeros(64, dtype=torch.int32)
        runs = [sh.anneal_sharded(prob, init, torch.Generator().manual_seed(9),
                                  steps=STEPS, mesh=mesh, block=4,
                                  exchange_every=every, return_stats=True)
                for every in (1, 1, 2)]
        assert torch.equal(runs[0].assignment, runs[1].assignment)
        assert runs[0].swap_attempts == runs[1].swap_attempts > 0
        assert int(runs[0].swap_accepts) == int(runs[1].swap_accepts)
        assert 0 < runs[2].swap_attempts <= 2
        a = to_np(runs[0].assignment)
        assert verify(pt, a)["total"] == float(runs[0].violations)


# the routing environments: (FLEET_SHARDED, FLEET_SHARDED_MIN_CELLS,
# FLEET_SHARDED_REPLICAS)
ROUTE_ENVS = [("", "", ""), ("1", "", ""), ("0", "", ""), ("", "100", ""),
              ("1", "", "2"), ("1", "", "3"), ("1", "", "16"),
              ("force", "", "x")]


def _set_env(monkeypatch, env):
    for name, v in zip(("FLEET_SHARDED", "FLEET_SHARDED_MIN_CELLS",
                        "FLEET_SHARDED_REPLICAS"), env):
        monkeypatch.setenv(name, v)


class TestRouting:
    @pytest.mark.parametrize("env", ROUTE_ENVS)
    @pytest.mark.parametrize("n", [1, 2, 4, 8])
    def test_route_matches_reference(self, n, env, monkeypatch):
        """sharded_route over n positions of one device decides as the
        reference over n devices, under the same environment."""
        _need_devices(8)
        _set_env(monkeypatch, env)
        devs = jax.devices()[:n]
        monkeypatch.setattr(ref_sh.jax, "devices", lambda *a, **k: devs)
        monkeypatch.setattr(sh, "visible_devices", lambda: ["cpu"] * n)
        ref = ref_sh.sharded_route(ref_synthetic(73, 12, seed=1))
        port = sh.sharded_route(synthetic_problem(73, 12, seed=1))
        assert (ref is None) == (port is None)
        if ref is not None:
            assert dict(ref.shape) == port.shape

    @pytest.mark.parametrize("cards", [1, 2, 4])
    def test_route_stays_off_on_cards(self, cards, monkeypatch):
        """Visible cards: one has nothing to route, distinct cards wait for
        the multi-card slice."""
        monkeypatch.setenv("FLEET_SHARDED", "1")
        monkeypatch.setattr(sh, "visible_devices", lambda: [
            torch.device("cuda", i) for i in range(cards)])
        assert sh.sharded_route(synthetic_problem(73, 12, seed=1)) is None

    def test_scheduler_routes_and_reuses_delta(self, monkeypatch):
        from fleetflow_tpu_torch.sched import GpuSolverScheduler
        monkeypatch.setenv("FLEET_SHARDED", "1")
        monkeypatch.setattr(sh, "visible_devices", lambda: CPU8)
        pt = synthetic_problem(73, 12, seed=31, port_fraction=0.3)
        sched = GpuSolverScheduler(chains=1, steps=STEPS, device="cpu")
        counts = REGISTRY.get("fleet_solver_sharded_solves_total")
        before = {k: counts.value(outcome=k) for k in ("cold", "delta")}
        p = sched.place(pt)
        assert p.raw.shape[0] == pt.S and p.feasible
        assert isinstance(sched._slots[0].resident, sh.ShardedResident)
        assert sched.last_result.tempering["replicas"] == 2
        valid = pt.node_valid.copy()
        valid[3] = False
        pt2 = dataclasses.replace(pt, node_valid=valid)
        r = sched.reschedule(pt2, delta=ProblemDelta(node_valid=valid))
        assert r.raw.shape[0] == pt.S
        assert not [s for s, n in r.assignment.items()
                    if n == pt.node_names[3]]
        assert counts.value(outcome="cold") == before["cold"] + 1
        assert counts.value(outcome="delta") == before["delta"] + 1
        assert len(sched._slots) == 1

    def test_routing_flip_cannot_reuse_sharded_slot(self, monkeypatch):
        from fleetflow_tpu_torch.sched import GpuSolverScheduler
        monkeypatch.setenv("FLEET_SHARDED", "1")
        monkeypatch.setattr(sh, "visible_devices", lambda: CPU8)
        pt = synthetic_problem(73, 12, seed=32, port_fraction=0.3)
        sched = GpuSolverScheduler(chains=1, steps=STEPS, device="cpu")
        sched.place(pt)
        monkeypatch.setenv("FLEET_SHARDED", "0")
        counts = REGISTRY.get("fleet_solver_sharded_solves_total")
        before = counts.value(outcome="cold") + counts.value(outcome="delta")
        valid = pt.node_valid.copy()
        valid[2] = False
        pt2 = dataclasses.replace(pt, node_valid=valid)
        r = sched.reschedule(pt2, delta=ProblemDelta(node_valid=valid))
        assert r.raw.shape[0] == pt.S
        assert counts.value(outcome="cold") + \
            counts.value(outcome="delta") == before
        assert sched.last_result.tempering is None
        assert not isinstance(sched._slots[0].resident, sh.ShardedResident)

    def test_place_many_solves_sharded_slots_alone(self, monkeypatch):
        from fleetflow_tpu_torch.sched import GpuSolverScheduler
        monkeypatch.setenv("FLEET_SHARDED", "1")
        monkeypatch.setattr(sh, "visible_devices", lambda: CPU8)
        pts = [synthetic_problem(73, 12, seed=40 + i) for i in range(2)]
        sched = GpuSolverScheduler(chains=1, steps=STEPS, device="cpu")
        sched.place_many([{"pt": p, "stage": f"s{i}"}
                          for i, p in enumerate(pts)])
        out = sched.place_many([{"pt": p, "stage": f"s{i}",
                                 "warm_start": True}
                                for i, p in enumerate(pts)])
        assert all(pl.feasible for pl in out)
        assert all(isinstance(s.resident, sh.ShardedResident)
                   for s in sched._slots)

    def test_api_solve_routes_and_stays_put(self, monkeypatch):
        from fleetflow_tpu_torch.solver import solve
        from fleetflow_tpu_torch.solver.resident import ResidentProblem
        monkeypatch.setenv("FLEET_SHARDED", "1")
        monkeypatch.setattr(sh, "visible_devices", lambda: CPU8)
        pt = synthetic_problem(73, 12, seed=33)
        res = solve(pt, steps=STEPS, seed=33)
        assert res.tempering is not None and res.tempering["replicas"] == 2
        assert res.assignment.shape[0] == pt.S
        assert verify(pt, res.assignment)["total"] == res.stats["total"]
        rp = ResidentProblem(pt, "cpu")
        res2 = solve(pt, prob=rp.prob, resident=rp, steps=STEPS, seed=33,
                     bucket=rp.bucket)
        assert res2.tempering is None
        # a knob the sharded path does not speak keeps the call here too
        assert solve(pt, steps=STEPS, chains=1, device="cpu").tempering \
            is None


class TestSolveContract:
    @pytest.mark.parametrize("dims", [(1, 8), (2, 4)])
    def test_cold_and_warm_hold_the_contract(self, dims):
        """Cold and warm solve_sharded: 0 violations, no host repair,
        nothing on the dead nodes, and a warm moved fraction within 5
        points of the reference's solve_sharded from the same seed
        assignment after the same churn."""
        _need_devices(8)
        pt = synthetic_problem(320, 40, seed=4, n_tenants=3)
        ref_pt = ref_synthetic(320, 40, seed=4, n_tenants=3)
        rp = sh.ShardedResident(pt, mesh=sh.tempering_mesh(*dims,
                                                           devices=CPU8))
        cold = sh.solve_sharded(pt, resident=rp, steps=64, seed=4)
        assert cold.feasible and cold.pre_repair_violations == 0
        assert verify(pt, cold.assignment)["total"] == 0
        valid = pt.node_valid.copy()
        busiest = np.argsort(-np.bincount(cold.assignment, minlength=pt.N))
        valid[busiest[:3]] = False
        forced = float((~valid[cold.assignment]).mean())
        pt2 = dataclasses.replace(pt, node_valid=valid)
        rp.apply_delta(pt2, ProblemDelta(node_valid=valid))
        warm = sh.solve_sharded(pt2, resident=rp, resident_warm=True,
                                steps=64, seed=5)
        assert warm.feasible and warm.pre_repair_violations == 0
        assert warm.moves_repaired == 0 and valid[warm.assignment].all()
        moved = float((warm.assignment != cold.assignment).mean())

        ref_rp = ref_sh.ShardedResident(ref_pt,
                                        mesh=ref_sh.tempering_mesh(*dims))
        ref_rp.adopt_host(cold.assignment, ref_pt.node_valid, warm=False)
        ref_pt2 = dataclasses.replace(ref_pt, node_valid=valid.copy())
        ref_rp.apply_delta(ref_pt2, RefDelta(node_valid=valid.copy()))
        ref_warm = ref_sh.solve_sharded(ref_pt2, resident=ref_rp,
                                        resident_warm=True, steps=64,
                                        seed=5)
        ref_moved = float((ref_warm.assignment != cold.assignment).mean())
        assert ref_warm.feasible
        assert moved >= forced
        assert moved <= ref_moved + 0.05, (moved, ref_moved, forced)

    def test_telemetry_and_counters(self):
        pt = synthetic_problem(73, 12, seed=2, port_fraction=0.3)
        rp = sh.ShardedResident(pt, mesh=sh.tempering_mesh(2, 4,
                                                           devices=CPU8))
        res = sh.solve_sharded(pt, resident=rp, steps=STEPS, seed=2,
                               init_assignment=np.zeros(73, np.int32),
                               block=4)
        tel = res.telemetry
        assert tel["schema"] == list(sh.SHARDED_TRACE_COLS)
        assert tel["mesh"] == "2x4" and tel["exit_sweep"] == res.steps
        assert len(tel["blocks"]) == -(-res.steps // 4)
        assert tel["blocks"][-1][4] == res.tempering["swap_attempts"]
        assert res.bucket["padded_S"] == rp.prob.S
        assert REGISTRY.get("fleet_solver_sharded_device_bytes").value() == \
            sum(sh.per_device_bytes(rp.prob, rp.mesh, state=True).values())

    def test_host_seed_raises_without_a_compiler(self, monkeypatch,
                                                 tmp_path):
        """No fallback: a host placer that cannot be built raises on the
        sharded cold seed."""
        from fleetflow_tpu_torch import _ext
        monkeypatch.setattr(_ext, "_host_libs", {})
        monkeypatch.setattr(_ext, "_BUILD_ROOT", tmp_path)
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        pt = synthetic_problem(73, 12, seed=2)
        rp = sh.ShardedResident(pt, mesh=sh.tempering_mesh(1, 8,
                                                           devices=CPU8))
        with pytest.raises(SolverError):
            sh.solve_sharded(pt, resident=rp, steps=STEPS)


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip_on_the_cpu(n):
    out = dryrun_multichip(n, device="cpu")
    assert out["violations_after"] < out["violations_before"]
    assert out["ragged_violations"] == 0 and out["ragged_padded_S"] % n == 0
