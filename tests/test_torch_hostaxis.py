"""The PyTorch port's host axis: one run over several processes, on gloo.

Mirrors tests/test_hostaxis.py and tests/hostaxis_worker.py for the
port. Real OS processes (delly_tpu_torch/testing/hostaxis_worker.py)
form a torch.distributed gloo world over localhost with
DELLY_TPU_COORD/NPROC/PROC_ID and run the port's CLI on the CPU
(DELLY_TPU_TORCH_DEVICE=cpu). The worlds start together, once per
module, on data made once from the port's generators:

- a 2-process world of the helpers themselves (gather, plan, writer,
  exchange);
- a 2-process and a 1-process world of the same CLI steps: `sr` on a
  4-contig mixed-SV genome, `sr -v` on its sites, `sr` on a
  tumor/control pair, `lr` on the long-read SV families, `cnv` with its
  coverage file, and `merge` of the `sr` calls (process 0 alone);
- a 3-process world of the `sr` step (4 contigs over 3 owners).

The same steps also run through the JAX package (`delly_tpu`, one
process, on the CPU) beside the worlds. Each output of every world must
equal the JAX package's, apart from ##fileDate (BCF decoded, gzip
decompressed). Each process has its own timeout.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import pytest

from torch_card import output_lines, run_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _reserve_port() -> socket.socket:
    """A localhost port, held by a socket that is bound (SO_REUSEADDR)
    and not listening. Released as soon as it is picked, the port could
    go to another process's bind to port 0 or outgoing connection (the
    other worlds' gloo pairs, the tests beside this file) in the seconds
    before the world's process 0 listens on it; held, no other socket is
    given it, while the world's TCPStore, which also sets SO_REUSEADDR,
    can still bind and listen on it."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("localhost", 0))
    return s


def start_world(case: str, outdir: str, nproc: int, held: list) -> list:
    """Starts an nproc-process world of the port's worker on a port that
    stays reserved (its socket appended to `held`) until the caller
    closes it."""
    os.makedirs(outdir, exist_ok=True)
    held.append(_reserve_port())
    port = held[-1].getsockname()[1]
    env = dict(os.environ, DELLY_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    for var in ("DELLY_TPU_DIST", "DELLY_TPU_MESH", "DELLY_TPU_PROFILE"):
        env.pop(var, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return [(outdir, pid, subprocess.Popen(
        [sys.executable, "-m", "delly_tpu_torch.testing.hostaxis_worker",
         str(pid), str(nproc), str(port), outdir, case],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for pid in range(nproc)]


def finish_world(procs: list) -> list:
    """Each process's result dict, in process order; fails on a process
    that exits non-zero or outlives its timeout (all are then killed)."""
    outs = []
    for outdir, pid, p in procs:
        try:
            _so, se = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for _d, _p, q in procs:
                q.kill()
                q.wait()
            pytest.fail(f"worker {pid} of {outdir} timed out")
        assert p.returncode == 0, (
            f"worker {pid} of {outdir} rc={p.returncode}\n"
            f"{se.decode()[-3000:]}")
        with open(os.path.join(outdir, f"p{pid}.pkl"), "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from delly_tpu_torch.testing.synth import (
        make_lr_sv_dataset, make_multi_contig_del_dataset,
        make_multi_sv_dataset, make_somatic_pair_dataset,
    )

    d = tmp_path_factory.mktemp("torch_hostaxis")
    data = str(d / "data")
    os.makedirs(data)
    bam, fa, _ = make_multi_sv_dataset(data, n_contigs=4, contig_len=200_000,
                                       pairs_per_contig=3000)
    tumor, control, sfa, _g, _s = make_somatic_pair_dataset(data)
    lbam, lfa, _ = make_lr_sv_dataset(data)
    cbam, cfa, _ = make_multi_contig_del_dataset(
        data, n_contigs=2, contig_len=120_000, pairs_per_contig=2500,
        name="cc1")
    sr = [["sr", "-g", fa, "-o", "{out}/sr.vcf", bam]]
    steps = sr + [
        ["sr", "-g", fa, "-v", "{out}/sr.vcf", "-o", "{out}/regeno.vcf",
         bam],
        ["sr", "-g", sfa, "-o", "{out}/pair.vcf", tumor, control],
        ["lr", "-g", lfa, "-o", "{out}/lr.vcf", lbam],
        ["cnv", "-g", cfa, "-c", "{out}/cov.gz", "-o", "{out}/cnv.bcf",
         cbam],
        ["merge", "-o", "{out}/merged.bcf", "{out}/sr.vcf"],
    ]
    paths = {}
    for name, st in (("steps", steps), ("sr", sr)):
        paths[name] = str(d / f"{name}.json")
        with open(paths[name], "w") as fh:
            json.dump(st, fh)
    jaxdir = d / "jax"
    os.makedirs(jaxdir)
    held = []
    started = {
        "primitives": start_world("primitives", str(d / "prim"), 2, held),
        "two": start_world(paths["steps"], str(d / "two"), 2, held),
        "one": start_world(paths["steps"], str(d / "one"), 1, held),
        "three": start_world(paths["sr"], str(d / "three"), 3, held),
    }
    res = {}
    try:
        jax_steps = [[a.replace("{out}", str(jaxdir)) for a in argv]
                     for argv in steps]
        res["jax"] = run_cli("delly_tpu", jax_steps, d, timeout=TIMEOUT)
        for name, procs in started.items():
            res[name] = finish_world(procs)
    finally:
        for procs in started.values():
            for _d, _p, q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        for sock in held:
            sock.close()
    return d, res


def _same(d, world, name):
    """The output `name` of `world` equals the 1-process world's and the
    JAX package's; returns its records."""
    want = output_lines(str(d / "jax" / name))
    assert want
    assert output_lines(str(d / "one" / name)) == want
    assert output_lines(str(d / world / name)) == want
    return [ln for ln in want if not ln.startswith("#")]


def test_primitives_two_process(worlds):
    _d, res = worlds
    outs = res["primitives"]
    assert [(o["formed"], o["index"], o["count"]) for o in outs] == [
        (True, 0, 2), (True, 1, 2)]
    assert outs[0]["gather"] == outs[1]["gather"] == [
        {"pid": 0, "data": [0, 0, 0]}, {"pid": 1, "data": [1, 1, 1]}]
    assert outs[0]["empty"] == outs[1]["empty"] == [b"x", b""]
    assert outs[0]["big"] == outs[1]["big"] == [256 * 40, 256 * 47]
    # ownership partitions the plan (round-robin, disjoint, covering)
    assert outs[0]["plan"] == [0, 2, 4, 6]
    assert outs[1]["plan"] == [1, 3, 5]
    assert [o["writer"] for o in outs] == [True, False]
    want = {k: f"p{k % 2}:{k}" for k in range(7)}
    assert outs[0]["merged"] == outs[1]["merged"] == want


def test_worlds_formed(worlds):
    """Every step exits 0 in every process of every world and in the
    JAX package's run; a world of one process forms too (and reports
    one process)."""
    _d, res = worlds
    assert res["jax"]["rcs"] == [0] * len(res["two"][0]["rcs"])
    for name, n in (("two", 2), ("one", 1), ("three", 3)):
        outs = res[name]
        assert [(o["index"], o["count"]) for o in outs] == [
            (p, n) for p in range(n)]
        assert [o["formed"] for o in outs] == [n > 1] * n
        for o in outs:
            assert set(o["rcs"]) == {0}, (name, o["rcs"])


def test_sr_multicontig_two_process(worlds):
    d, _res = worlds
    body = _same(d, "two", "sr.vcf")
    types = {ln.split("SVTYPE=")[1].split(";")[0] for ln in body}
    assert {"DEL", "DUP", "INV", "INS", "BND"} <= types


def test_sr_multicontig_three_process(worlds):
    d, _res = worlds
    assert _same(d, "three", "sr.vcf")


def test_sr_regenotyping_two_process(worlds):
    d, _res = worlds
    assert _same(d, "two", "regeno.vcf")


def test_sr_multisample_two_process(worlds):
    d, _res = worlds
    body = _same(d, "two", "pair.vcf")
    assert body and len(body[0].split("\t")) == 11


def test_lr_two_process(worlds):
    d, _res = worlds
    body = _same(d, "two", "lr.vcf")
    types = {ln.split("SVTYPE=")[1].split(";")[0] for ln in body}
    assert "BND" in types and "DEL" in types


def test_cnv_two_process(worlds):
    d, _res = worlds
    assert _same(d, "two", "cnv.bcf")
    cov = _same(d, "two", "cov.gz")
    assert len(cov) > 30


def test_merge_gated_to_writer_process(worlds):
    """merge runs in process 0 alone; process 1 waits at the barrier and
    both exit 0."""
    d, res = worlds
    assert _same(d, "two", "merged.bcf")
    assert all(o["outputs"]["merged.bcf"] for o in res["two"])
