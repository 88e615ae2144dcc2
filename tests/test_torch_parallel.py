"""The port's parallel/ package on the CPU (counterpart of the JAX
package's tests/test_distributed.py bring-up test and tests/test_ntc_step.py).

* init_distributed(required=True) raises when the bring-up fails, after
  reading the DYNAMONT_* variables; without them it takes torchrun's
  ("env://").
* pool_params / pool_ntc_params equal JAX's on the same numpy stats, and
  the device estimates (_trans_probs_device, _emission_estimates_device)
  JAX's and the port's host trans_from_terms / emissions_from_moments.
* The sharded basic and NTC steps on ["cpu", "cpu"], fp64: every per-read
  output bit for bit the one-device program's on the same padded batch
  (shares of unequal size, and a device left without a read), the pooled
  sums within 1e-12 of the one-device step's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu.parallel import ntc_step as jax_ntc_step
from dynamont_tpu.parallel import train_step as jax_train_step
from dynamont_tpu_torch.constants import NT_TRANSITIONS
from dynamont_tpu_torch.models import ntc_batch as ntc_mod
from dynamont_tpu_torch.models.registry import load_model_for_pore
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops.ntc_batch import TERMS
from dynamont_tpu_torch.ops.nt_banded_train import banded_batch_train
from dynamont_tpu_torch.parallel import mesh
from dynamont_tpu_torch.parallel import ntc_step
from dynamont_tpu_torch.parallel import train_step
from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids

from tests.synthetic import make_read

M1, E2 = NT_TRANSITIONS["rna002"]["m1"], NT_TRANSITIONS["rna002"]["e2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def test_init_distributed_required_fails_loudly(monkeypatch):
    calls = []

    def boom(*a, **kw):
        calls.append(kw)
        raise ValueError("no coordinator reachable")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    monkeypatch.setenv("DYNAMONT_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("DYNAMONT_NUM_PROCESSES", "2")
    monkeypatch.setenv("DYNAMONT_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="distributed run requested"):
        mesh.init_distributed(required=True)
    kw = calls[0]
    assert (kw["backend"], kw["init_method"], kw["world_size"], kw["rank"]) == (
        "gloo", "tcp://127.0.0.1:1", 2, 0)
    assert kw["timeout"].total_seconds() == mesh.TIMEOUT_S
    # without required: a single-process run goes on
    assert mesh.init_distributed(required=False) is False
    for var in ("DYNAMONT_COORDINATOR", "DYNAMONT_NUM_PROCESSES", "DYNAMONT_PROCESS_ID"):
        monkeypatch.delenv(var)
    with pytest.raises(RuntimeError):
        mesh.init_distributed(required=True)
    assert calls[-1]["init_method"] == "env://"
    assert calls[-1]["timeout"].total_seconds() == mesh.TIMEOUT_S
    assert mesh.rank_world() == (0, 1)


def test_local_devices(monkeypatch):
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.local_devices("cuda") == [torch.device("cuda", i) for i in range(3)]
    assert mesh.local_devices("cuda:2") == [torch.device("cuda", 2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.local_devices("cuda")


def test_pool_params_match_jax():
    rng = np.random.default_rng(5)
    K = 64
    count = rng.integers(0, 4, K).astype(np.float64)
    stats = dict(m1_sum=rng.random() * 3, e2_sum=rng.random() * 3, n_valid=3.0,
                 mean_sum=rng.normal(size=K) * count, stdev_sum=rng.random(K) * count,
                 kmer_count=count, z_sum=-1234.5678)
    got = train_step.pool_params(train_step.PooledStats(**stats))
    want = jax_train_step.pool_params(jax_train_step.PooledStats(**stats))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(want[k], float),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    # tensors pool as their numpy values
    t = train_step.PooledStats(**{k: torch.as_tensor(v, dtype=torch.float64)
                                  for k, v in stats.items()})
    assert train_step.pool_params(t)["m1"] == pytest.approx(stats["m1_sum"] / 3, rel=1e-15)
    assert train_step.pool_params(t._replace(n_valid=torch.tensor(0.0))) is None


def test_pool_ntc_params_match_jax():
    rng = np.random.default_rng(6)
    K = 32
    count = rng.integers(0, 3, K).astype(np.float64)
    fields = dict(trans_sum=rng.random(13), n_valid=2.0, mean_sum=rng.normal(size=K),
                  stdev_sum=rng.random(K), kmer_count=count, z_sum=-55.25)
    got = ntc_step.pool_ntc_params(ntc_step.NTCPooled(**fields))
    want = jax_ntc_step.pool_ntc_params(jax_ntc_step.NTCPooled(**fields))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(want[k], float),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    assert ntc_step.pool_ntc_params(ntc_step.NTCPooled(**{**fields, "n_valid": 0.0})) is None


def test_device_estimates_match_jax_and_host(model):
    rng = np.random.default_rng(9)
    R, K = 5, model.num_kmers
    term_lse = rng.normal(-3.0, 4.0, (13, R))
    term_lse[[TERMS.index(k) for k in ("e3", "p1")], 1] = -np.inf   # an all -inf group
    term_lse[TERMS.index("a2"), 2] = -np.inf
    got = ntc_step._trans_probs_device(torch.from_numpy(term_lse)).numpy()
    want = np.asarray(jax_ntc_step._trans_probs_device(jnp.asarray(term_lse)))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    for r in range(R):
        host = ntc_mod.trans_from_terms(term_lse[:, r])
        np.testing.assert_allclose(got[:, r], [host[k] for k in TERMS], rtol=1e-13, atol=0)

    norm = rng.random((R, K)) * (rng.random((R, K)) < 0.3)
    norm[0, :5] = 5e-8                                        # under the threshold
    em = np.stack([norm, rng.normal(size=(R, K)) * norm,
                   rng.random((R, K)) * norm * 2], axis=1)
    means_t = torch.from_numpy(np.asarray(model.means, np.float64))
    gm, gs, gc = (x.numpy() for x in ntc_step._emission_estimates_device(
        torch.from_numpy(em), means_t))
    wm, ws, wc = (np.asarray(x) for x in jax_ntc_step._emission_estimates_device(
        jnp.asarray(em), jnp.asarray(model.means, jnp.float64)))
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gm, wm, rtol=1e-14, atol=0)
    np.testing.assert_allclose(gs, ws, rtol=1e-14, atol=0)
    for r in range(R):
        host = ntc_mod.emissions_from_moments(em[r], model)
        ks = np.nonzero(gc[r])[0]
        assert len(host) == len(ks) > 0
        for k, (m, s) in zip(ks, host.values()):
            assert m == pytest.approx(gm[r, k], rel=1e-14)
            assert s == pytest.approx(gs[r, k], rel=1e-14)


def _basic_batch(model, n_reads):
    reads = [make_read(model, n_bases=30 + 6 * s, seed=40 + s) for s in range(n_reads)]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in reads]
    batch = bb.prepare_batch([s for s, _ in reads], kids, model, device="cpu",
                             dtype=torch.float64, t_pad_to=512)
    kid_pad = np.zeros((n_reads, max(len(k) for k in kids)), np.int32)
    for i, k in enumerate(kids):
        kid_pad[i, : len(k)] = k
    return batch, kid_pad


def _bits(x):
    x = x.numpy()
    return x.view(np.uint8) if x.dtype != bool else x


@pytest.mark.parametrize("n_reads", [3, 1])
def test_sharded_basic_step_matches_one_device(model, n_reads):
    batch, kid_pad = _basic_batch(model, n_reads)
    lm, le = math.log(M1), math.log(E2)
    want = banded_batch_train(batch, lm, le, kid_pad, model.num_kmers)
    pooled = {}
    for devs in (["cpu"], ["cpu", "cpu"]):
        step = train_step.make_sharded_train_step(devs, M1, E2, model.num_kmers,
                                                  pad=batch.pad, B=batch.B,
                                                  dtype=torch.float64)
        shards = train_step.shard_batch(batch, kid_pad, devs)
        assert [(s.lo, s.hi) for s in shards] == (
            [(0, n_reads)] if len(devs) == 1 else [(0, 2), (2, 3)] if n_reads == 3
            else [(0, 1)])
        out = step(shards)
        for name, g, w in zip(bb.BandedTrainResult._fields, out.per_read, want):
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
        pooled[len(devs)] = out.pooled
        assert float(out.pooled.n_valid) == n_reads
    for name, a, b in zip(train_step.PooledStats._fields, pooled[2], pooled[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    assert train_step.pool_params(pooled[2])["m1"] == pytest.approx(
        float(want.m1.mean()), rel=1e-12)


def test_sharded_ntc_step_matches_one_device(model):
    reads = [make_read(model, n_bases=16 + 3 * s, seed=60 + s) for s in range(3)]
    pad = dict(t_pad_to=64, n_pad_to=16)
    dt = torch.float64
    shard1 = ntc_step.prepare_ntc_shard(reads, model, ["cpu"], **pad)
    p = shard1.parts[0]
    eng = ntc_mod.NTCBatchEngine(model, "rna002", device="cpu", dtype=dt, **pad)
    want = ntc_mod.ntc_train_bucket_program(
        p.sig.to(dt), p.kid, p.N, p.T, eng.tensors, A=model.alphabet_size,
        S=model.kmer_size, log_ppm=eng.log_ppm, log_ppe=eng.log_ppe,
        trans_log=eng.trans_log, CN=eng.cap_n, CK0=eng.cap_k, dtype=dt)
    outs = {}
    for devs in (["cpu"], ["cpu", "cpu"]):
        shard = ntc_step.prepare_ntc_shard(reads, model, devs, **pad)
        assert [(q.lo, q.hi) for q in shard.parts] == (
            [(0, 3)] if len(devs) == 1 else [(0, 2), (2, 3)])
        outs[len(devs)] = ntc_step.make_ntc_sharded_train_step(
            devs, model, "rna002", dtype=dt)(shard)
    got = outs[2]
    assert got["ok"].all()
    for k in ("Zf", "Zb", "term_lse", "em"):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    for name, a, b in zip(ntc_step.NTCPooled._fields, got["pooled"], outs[1]["pooled"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    assert float(got["pooled"].n_valid) == 3
    with pytest.raises(ValueError, match="slots"):
        ntc_step.prepare_ntc_shard(reads * 11, model, ["cpu", "cpu"], **pad)


@pytest.mark.parametrize("mode", ["basic", "resquiggle"])
def test_trainer_on_two_devices_matches_one(model, tmp_path, monkeypatch, mode):
    """The Trainer on ["cpu", "cpu"] (the sharded basic step, or the
    sharded NTC step in shares of 16) writes the files one device writes."""
    import functools

    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.registry import get_model_path
    from dynamont_tpu_torch.training import trainer as tr
    from dynamont_tpu_torch.utils.synthetic import signal_to_text

    pad = dict(t_pad_to=64, n_pad_to=16)
    monkeypatch.setattr(tr, "NTCBatchEngine", functools.partial(ntc_mod.NTCBatchEngine, **pad))
    monkeypatch.setattr(tr, "prepare_ntc_shard", functools.partial(
        ntc_step.prepare_ntc_shard, **pad))
    n_bases = 30 if mode == "basic" else 18
    tsv = tmp_path / "reads.tsv"
    tsv.write_text("".join(
        f"r{s}\ts{s}\t{signal_to_text(sig)}\t{read[::-1]}\n"
        for s, (sig, read) in enumerate(make_read(model, n_bases=n_bases + s, seed=80 + s)
                                        for s in range(3))))
    jobs = list(readers.generate_tsv_jobs(str(tsv), rna=True))
    files = {}
    for name, kw in (("one", dict(device="cpu")), ("two", dict(devices=["cpu", "cpu"]))):
        t = tr.Trainer(mode, "rna002", str(tmp_path / name), get_model_path("rna002"),
                       batch_size=3, precision="fp64", **kw)
        t.process_batch(jobs, epoch=0)
        t.close()
        assert t.reads_done == 3
        files[name] = {p.name: p.read_bytes() for p in sorted((tmp_path / name).iterdir())}
    assert sorted(files["one"]) == ["params.csv", "trained_0_0.model", "trained_0_1.model"]
    assert files["two"] == files["one"]
