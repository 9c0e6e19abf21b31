"""The PyTorch port's `sr` on long split reads against the JAX package.

Split reads longer than 8,192 bases make `sr`'s split-read MSA merge two
long sequences, which takes the corridor DP: the host corridor
gotoh_banded_host in delly_tpu on the CPU, the kernels K3/K3-tb
(here their plain versions) in the port. On a small instance of
make_long_split_dataset (one 200 kb contig, 2 DELs x 2 reads of about
9 kb), `python -m delly_tpu_torch.cli sr` runs in a subprocess with
DELLY_TPU_TORCH_DEVICE=cpu while `delly_tpu.cli sr` runs in this
process. The VCFs must be equal apart from ##fileDate, both runs must
have taken the corridor branch, the port with no host route, and both
DELs must be called.
"""

import json
import os
import subprocess
import sys

import delly_tpu.ops.gotoh_banded as jbanded
from delly_tpu.cli import main as jax_main
from delly_tpu_torch.testing.synth import make_long_split_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DRIVER = (
    "import json, sys\n"
    "from delly_tpu_torch.ops import gotoh_banded_cuda as g\n"
    "from delly_tpu_torch.parallel import dispatch\n"
    "jobs = []\n"
    "forward = g.banded_forward\n"
    "def spy(s1, *args, **kwargs):\n"
    "    jobs.append(s1.shape[0])\n"
    "    return forward(s1, *args, **kwargs)\n"
    "g.banded_forward = spy\n"
    "from delly_tpu_torch.cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "leaked = sorted(m for m in sys.modules\n"
    "                if m.split('.')[0] in ('jax', 'delly_tpu'))\n"
    "print('RESULT=' + json.dumps({'leaked': leaked, 'corridor_jobs':\n"
    "      sum(jobs), 'host_routes': dispatch.snapshot()['host_routes']}))\n"
    "sys.exit(rc)\n")


def _body(path):
    with open(path) as fh:
        return [ln for ln in fh if not ln.startswith("##fileDate")]


def test_sr_long_split_matches_jax(tmp_path, monkeypatch):
    bam, fa, truth = make_long_split_dataset(
        str(tmp_path), n_contigs=1, contig_len=200_000, dels_per_contig=2,
        reads_per_del=2, read_len=9000, jitter=100, pairs_per_contig=3000,
        seed=228)
    want, got = str(tmp_path / "jax.vcf"), str(tmp_path / "port.vcf")
    env = dict(os.environ, DELLY_TPU_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    port = subprocess.Popen(
        [sys.executable, "-c", PORT_DRIVER, "sr", "-g", fa, "-o", got, bam],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        corridor = []
        host = jbanded.gotoh_banded_host

        def spy(*args, **kwargs):
            corridor.append(args[0].shape)
            return host(*args, **kwargs)

        monkeypatch.setattr(jbanded, "gotoh_banded_host", spy)
        assert jax_main(["sr", "-g", fa, "-o", want, bam]) == 0
        out, err = port.communicate(timeout=300)
    finally:
        if port.poll() is None:
            port.kill()
            port.communicate()
    assert port.returncode == 0, err[-2000:]
    result = json.loads([ln for ln in out.splitlines()
                         if ln.startswith("RESULT=")][-1][len("RESULT="):])
    assert result == {"leaked": [], "corridor_jobs": 2, "host_routes": 0}
    assert len(corridor) == 2
    body = _body(got)
    assert body == _body(want)
    calls = [ln.split("\t") for ln in body if not ln.startswith("#")]
    assert len(calls) == len(truth)
    for (_t, chrom, start, end), c in zip(truth, calls):
        info = dict(f.split("=", 1) for f in c[7].split(";") if "=" in f)
        assert c[0] == chrom and info["SVTYPE"] == "DEL"
        assert abs(int(c[1]) - start) <= 3 and abs(int(info["END"]) - end) <= 3
