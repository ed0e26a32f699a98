"""
The port's multi-process profile (instrain_tpu_torch/parallel/
distributed.py, --distributed) on the CPU: two processes joined by gloo
on 127.0.0.1 write the one-process run's profile byte for byte, on the
ranged path (a .bai, paired_only: each process decodes only its
scaffolds) and on the replicated one (no .bai, or non_discordant), also
where reads have pairs on two scaffolds; under distributed_store "all"
both processes write it; a zero-pair run writes only from process 0.
Under --engine batch the writing processes stream covT/clonT/clonTR
(their own scaffolds in the loop, the gathered ones after it): the hd5
files hold the one-process run's datasets (created in another order),
and without h5py the pickles are its bytes.
Also: the scaffold assignment equals the JAX package's, the one-process
pass-throughs, the histogram median, and each scaffold's pair order,
which does not depend on the decode's scope.

Every subprocess wait has a timeout, and so has the process group
(INSTRAIN_DIST_TIMEOUT), so that a hang fails the test.
"""

import gzip
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from instrain_tpu.parallel.distributed import \
    assign_scaffolds_to_hosts as jax_assign
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.config import ReadFilterConfig
from instrain_tpu_torch.io.bam import decode_bam
from instrain_tpu_torch.parallel import distributed as D
from instrain_tpu_torch.profile import filter_reads as F
from instrain_tpu_torch.store import profile_dir as PD
from instrain_tpu_torch.synth import synth, synth_shared_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]
TABLES = ["SNVs", "scaffold_info", "linkage", "mapping_info"]
WAIT_S = 180

# one process of a two-process run: joins the group, then runs each job
# of argv[1] (a JSON list) through profile(), printing what it did
WORKER = """
import json, logging, sys
logging.basicConfig(level=logging.INFO, format="%(message)s")
from instrain_tpu_torch.cli import build_parser, profile_config_from_args
from instrain_tpu_torch.parallel import distributed
from instrain_tpu_torch.profile.pipeline import profile
from instrain_tpu_torch.store import profile_dir
assert distributed.init_distributed()
rank = distributed.process_index()
h5py_of = profile_dir._h5py
for job in json.loads(sys.argv[1]):
    profile_dir._h5py = (lambda: None) if job.get("no_h5py") else h5py_of
    cfg = profile_config_from_args(build_parser().parse_args(
        ["profile", job["bam"], job["fasta"], "-o",
         job["out"].format(rank=rank), "--device", "cpu"] + job["flags"]))
    cfg.distributed_store = job.get("store", "primary")
    try:
        profile(job["bam"], job["fasta"], cfg)
        print("JOB_OK", rank, flush=True)
    except RuntimeError as e:
        print("JOB_RAISED", rank, e, flush=True)
distributed.shutdown_distributed()
print("WORKER_DONE", rank, flush=True)
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread for this module's runs (and OMP_NUM_THREADS=1 in
    its processes), so that they do not contend with the other test
    workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(rank, port):
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               INSTRAIN_DIST_TIMEOUT="60", OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two(argv_of_rank, tmp_path, tag):
    """Start two processes (argv_of_rank(rank)), wait for both with a
    timeout; returns their outputs and exit codes."""
    port = _free_port()
    procs, logs = [], []
    try:
        for rank in (0, 1):
            logs.append(open(tmp_path / f"{tag}_{rank}.log", "wb"))
            procs.append(subprocess.Popen(
                argv_of_rank(rank), env=_env(rank, port), cwd=REPO,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=WAIT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=WAIT_S)
        for f in logs:
            f.close()
    return ([(tmp_path / f"{tag}_{r}.log").read_text() for r in (0, 1)],
            [p.returncode for p in procs])


def run_workers(jobs, tmp_path, tag):
    outs, rcs = run_two(lambda r: [sys.executable, "-c", WORKER,
                                   json.dumps(jobs)], tmp_path, tag)
    for out, rc in zip(outs, rcs):
        assert rc == 0 and "WORKER_DONE" in out, out[-3000:]
    return outs


def one_process(bam, fasta, out, extra=()):
    assert port_main(["profile", bam, fasta, "-o", out, "--device", "cpu"] +
                     FLAGS + list(extra)) == 0
    return out


def hd5_content(path):
    """{dataset: (dtype, shape, compression, values)} of an hd5 file."""
    import h5py
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, f[k].shape, f[k].compression,
                    f[k][()].tobytes()) for k in f.keys()}


def assert_same_profile(a, b, hd5_by_content=False):
    """Every output TSV byte for byte, and every stored table: the text
    files and pickles byte for byte, the gzipped tables decompressed, the
    special views (hd5 or pickle) byte for byte, or with hd5_by_content
    the hd5 files dataset by dataset (name, dtype, shape, compression and
    value bytes: the batch engine's streamed files create them in another
    order); the attribute registry with each directory's own path taken
    out."""
    for t in TABLES:
        texts = []
        for d in (a, b):
            with open(os.path.join(d, "output",
                                   f"{os.path.basename(d)}_{t}.tsv")) as f:
                texts.append(f.read())
        assert texts[0] == texts[1], t
    ra, rb = os.path.join(a, "raw_data"), os.path.join(b, "raw_data")
    assert sorted(os.listdir(ra)) == sorted(os.listdir(rb))
    for name in sorted(os.listdir(ra)):
        if hd5_by_content and name.endswith(".hd5"):
            assert hd5_content(os.path.join(ra, name)) == \
                hd5_content(os.path.join(rb, name)), name
            continue
        blobs = []
        for d, r in ((a, ra), (b, rb)):
            path = os.path.join(r, name)
            opener = gzip.open if name.endswith(".gz") else open
            with opener(path, "rb") as f:
                blob = f.read()
            if name == "attributes.tsv":
                blob = blob.replace(os.path.abspath(d).encode(), b"DIR")
            blobs.append(blob)
        assert blobs[0] == blobs[1], name


def _log(d):
    with open(os.path.join(d, "log", "log.log")) as f:
        return f.read()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    fasta, bam, _ = synth(str(d), S=5, L=4000, COV=30, seed=3)
    plain = str(d / "plain")
    os.makedirs(plain)
    nobai = shutil.copy(bam, os.path.join(plain, "synth.bam"))
    shared = str(d / "shared")
    os.makedirs(shared)
    sfasta, sbam, _ = synth_shared_reads(shared, S=3, L=5000, COV=30)
    return dict(fasta=fasta, bam=bam, nobai=nobai, sfasta=sfasta, sbam=sbam)


def test_assignment_matches_jax():
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 8):
        w = {f"s{i}": int(rng.integers(0, 10000)) for i in range(60)}
        w.update({"tie_a": 5, "tie_b": 5, "tie_c": 5})
        assert D.assign_scaffolds_to_hosts(w, n) == jax_assign(w, n)


def test_single_process_passthroughs(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert D.init_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.init_distributed() is False
    assert (D.process_count(), D.process_index()) == (1, 0)
    tables = [pd.DataFrame({"x": [1, 2]})]
    assert D.allgather_tables(tables) is tables
    assert sorted(D.my_scaffolds({"a": 10, "b": 1})) == ["a", "b"]
    D.shutdown_distributed()          # nothing to leave


def test_median_from_hist():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 1000):
        x = rng.integers(200, 400, n)
        vals, cnts = np.unique(x, return_counts=True)
        got = F._median_from_hist(vals, cnts)
        want = np.median(x) if n else np.nan
        assert (np.isnan(got) and np.isnan(want)) or got == want


def test_pair_order_is_decode_invariant(data):
    """On a BAM where reads have pairs on two scaffolds, a ranged decode
    of a later scaffold numbers its qnames otherwise than the full decode
    (the pairs' qname_id order differs), yet its pairs come in the same
    order: the Rdic entries, the mapping_info rows and the pair arrays."""
    full = decode_bam(data["sbam"])
    cfg = ReadFilterConfig()
    pf = F.filter_reads(full, cfg)
    for name in ("scaf_1", "scaf_2"):
        ranged = decode_bam(data["sbam"], scaffolds=[name])
        assert ranged.ranged
        pr = F.filter_reads(ranged, cfg, scaffolds=[name])
        assert list(pf.rdic()[name].items()) == list(pr.rdic()[name].items())
        row = pf.mapping_info[pf.mapping_info["scaffold"] == name]
        pd.testing.assert_frame_equal(
            row.reset_index(drop=True),
            pr.mapping_info.iloc[1:].reset_index(drop=True),
            check_exact=True)
        names_f = [full.qnames[q] for q in pf.r2m_for_scaffold(
            full.name_to_ref_id[name])[0]]
        names_r = [ranged.qnames[q] for q in pr.r2m_for_scaffold(
            ranged.name_to_ref_id[name])[0]]
        assert names_f == names_r
        # the trap: by the decoder's numbering the two orders differ
        info = F.pair_info_from_records(full)
        q = info.qname_id[info.ref_id == full.name_to_ref_id[name]]
        assert (np.diff(q) < 0).any()


def test_pair_order_is_qname_order_without_shared_reads(data):
    """Where no read has records on two scaffolds, the order is the
    qname_id order the JAX package sorts by (so the byte parity with it
    holds)."""
    bam = decode_bam(data["bam"])
    info = F.pair_info_from_records(bam)
    order = np.lexsort((info.qname_id, info.ref_id))
    assert (order == np.arange(len(order))).all()


def test_two_processes_through_torchrun(data, tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 -m
    instrain_tpu_torch.cli profile --distributed --device cpu`: each
    process ranged-decodes and profiles its own scaffolds, process 0
    writes the directory both share, and it equals the one-process run's
    byte for byte."""
    one = one_process(data["bam"], data["fasta"], str(tmp_path / "one.IS"))
    out = str(tmp_path / "two.IS")
    port = _free_port()
    env = _env(0, port)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k)
    log = tmp_path / "torchrun.log"
    with open(log, "wb") as f:
        p = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
             "--master_port", str(port), "-m", "instrain_tpu_torch.cli",
             "profile", data["bam"], data["fasta"], "-o", out,
             "--distributed", "--device", "cpu"] + FLAGS,
            env=env, cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
            timeout=WAIT_S)
    text = log.read_text()
    assert p.returncode == 0, text[-3000:]
    assert_same_profile(one, out)
    own = _log(out)
    assert "sharded decode: host 0 ranged-decoded" in own
    assert "multi-host: process 0 of 2 owns" in own
    assert "process 1 of 2 owns" not in own       # process 1 logs apart
    assert "sharded decode: host 1 ranged-decoded" in text
    counts = [int(text.split(f"process {r} of 2 owns ")[1].split()[0])
              for r in (0, 1)]
    assert sum(counts) == 5 and min(counts) > 0


def test_two_processes_every_path(data, tmp_path, monkeypatch):
    """One pair of processes runs, in turn: the ranged path with
    distributed_store "all" (both write a whole directory), the
    replicated paths (the BAM without its .bai; non_discordant), the BAM
    with reads on two scaffolds, the batch engine's streamed stores with
    distributed_store "all" and, without h5py, with "primary", and a run
    where no pair passes (it fails on both, and only process 0 writes).
    Each directory equals the one-process run's byte for byte (the batch
    runs' hd5 files dataset by dataset)."""
    batch = ["--engine", "batch"]
    runs = {
        "all": (data["bam"], data["fasta"], "all", []),
        "nobai": (data["nobai"], data["fasta"], "primary", []),
        "nondisc": (data["bam"], data["fasta"], "primary",
                    ["--pairing_filter", "non_discordant"]),
        "shared": (data["sbam"], data["sfasta"], "all", []),
        "batch": (data["bam"], data["fasta"], "all", batch),
        "batch_pickle": (data["bam"], data["fasta"], "primary", batch),
        "zero": (data["bam"], data["fasta"], "primary",
                 ["--min_read_ani", "1.0"]),
    }
    jobs = [dict(bam=b, fasta=f, out=str(tmp_path / f"{k}_{{rank}}.IS"),
                 store=store, flags=FLAGS + extra,
                 no_h5py=k == "batch_pickle")
            for k, (b, f, store, extra) in runs.items()]
    del runs["zero"]
    outs = run_workers(jobs, tmp_path, "every")
    for rank, text in enumerate(outs):
        assert text.count(f"JOB_OK {rank}") == 6, text[-3000:]
        assert f"JOB_RAISED {rank} No paired reads remain" in text
    for k, (bam, fasta, store, extra) in runs.items():
        with monkeypatch.context() as m:
            if k == "batch_pickle":
                m.setattr(PD, "_h5py", lambda: None)
            one = one_process(bam, fasta, str(tmp_path / f"{k}_one.IS"),
                              extra)
        writers = (0, 1) if store == "all" else (0,)
        for rank in (0, 1):
            d = str(tmp_path / f"{k}_{rank}.IS")
            if rank in writers:
                assert_same_profile(one, d, hd5_by_content=k == "batch")
            else:
                assert not os.path.exists(d), (k, rank)
        if k.startswith("batch"):
            specials = sorted(f for f in os.listdir(
                os.path.join(one, "raw_data")) if f.startswith(
                    ("covT", "clonT", "clonTR")))
            ext = ".pickle" if k == "batch_pickle" else ".hd5"
            assert specials == [f"clonT{ext}", f"clonTR{ext}",
                                f"covT{ext}"], specials
        log = _log(str(tmp_path / f"{k}_0.IS"))
        assert "multi-host: process 0 of 2 owns" in log
        ranged = k in ("all", "shared", "batch", "batch_pickle")
        assert ("sharded decode: host 0" in log) == ranged, k
    assert os.path.exists(tmp_path / "zero_0.IS" / "raw_data" /
                          "mapping_info.csv.gz")
    assert not os.path.exists(tmp_path / "zero_1.IS")


def test_dead_peer_fails_the_run(data, tmp_path):
    """A process that never joins makes its peer's run fail when the
    group's timeout expires, instead of hanging it."""
    env = _env(0, _free_port())
    env["INSTRAIN_DIST_TIMEOUT"] = "2"
    p = subprocess.run(
        [sys.executable, "-m", "instrain_tpu_torch.cli", "profile",
         data["bam"], data["fasta"], "-o", str(tmp_path / "dead.IS"),
         "--distributed", "--device", "cpu"] + FLAGS,
        env=env, cwd=REPO, capture_output=True, timeout=WAIT_S)
    assert p.returncode != 0
    assert b"Timed out" in p.stdout + p.stderr
