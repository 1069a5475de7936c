"""The port's CLI (`python -m ldweaver_tpu_torch.cli`) against the JAX
package's: every option of the JAX parser parses; `run --device cpu`
takes a small synthetic input (16 genomes x 100 kb x 800 SNPs) through
all twelve blocks (backend "fast", the default of both CLIs);
`lr-analyse`, `ldmap` and `snp-fasta` write the same bytes as the JAX CLI
on the same inputs; `--backend fast`, `--pipeline-depth` and
`--device-budget-bytes` give the JAX CLI's links; the multi-device
options reach the configuration, and a multi-process bring-up without its
coordinator, process count or id raises (tests/test_torch_multihost.py
runs two processes)."""

import os
import subprocess
import sys

import pytest

import ldweaver_tpu.cli as jcli
import ldweaver_tpu_torch.cli as tcli
from tests.test_torch_fast_sweep import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def subcommands(parser):
    (sub,) = [a for a in parser._actions if a.dest == "cmd"]
    return sub.choices


def test_every_jax_option_parses():
    jax_cmds, port_cmds = subcommands(jcli.build_parser()), subcommands(tcli.build_parser())
    assert set(jax_cmds) == set(port_cmds) == {"run", "lr-analyse", "ldmap", "snp-fasta"}
    for name, sub in jax_cmds.items():
        missing = set(sub._option_string_actions) - set(port_cmds[name]._option_string_actions)
        assert not missing, (name, missing)
    args = tcli.build_parser().parse_args(["run", "--dset", "d", "--aln", "a.fa"])
    assert args.backend == "fast" and args.device == "cuda"
    assert jcli.build_parser().parse_args(["run", "--dset", "d", "--aln", "a.fa"]).backend == "fast"


def test_help_runs():
    proc = subprocess.run([sys.executable, "-m", "ldweaver_tpu_torch.cli", "run", "--help"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout


@pytest.fixture(scope="module")
def run_dset(tmp_path_factory):
    from examples.bench_e2e import synth_alignment

    d = tmp_path_factory.mktemp("cli")
    synth_alignment(str(d / "aln.fa.gz"), str(d / "ref.gbk"), nseq=16,
                    g=100_000, nsnp=800)
    rc = tcli.main(["run", "--dset", str(d / "out"), "--aln", str(d / "aln.fa.gz"),
                    "--gbk", str(d / "ref.gbk"), "--device", "cpu",
                    "--max-blk-sz", "1000", "--save-additional-outputs"])
    assert rc == 0
    return d


def test_run_writes_tophits(run_dset):
    for name in ("sr_tophits.tsv", "lr_tophits.tsv"):
        assert os.path.getsize(run_dset / "out" / "Tophits" / name) > 1000


@pytest.mark.parametrize("cmd", ["lr-analyse", "ldmap", "snp-fasta"])
def test_standalone_commands_byte_identical(run_dset, tmp_path, cmd):
    temp = run_dset / "out" / "Temp"
    links = ["--lr-links", str(temp / "lr_links.tsv"), "--sr-links", str(temp / "sr_links.tsv")]
    outputs = {"lr-analyse": ["lr_gwes.png"], "ldmap": ["ld.png"],
               "snp-fasta": ["snps.fa", "snps.pos"]}[cmd]
    for pkg, cli in (("jax", jcli), ("torch", tcli)):
        out = tmp_path / pkg
        argv = {
            "lr-analyse": ["--dset", str(out), *links],
            "ldmap": [*links, "--out", str(out / "ld.png"), "--title", "LD"],
            "snp-fasta": ["--snp-npz", str(run_dset / "out" / "Additional_Outputs"
                                           / "snp_ACGTN.npz"),
                          "--out-aln", str(out / "snps.fa"),
                          "--out-pos", str(out / "snps.pos")],
        }[cmd]
        out.mkdir()
        assert cli.main([cmd, *argv]) == 0
    for name in outputs:
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "torch" / name).read_bytes()
        assert len(a) > 1000 and a == b, name


@pytest.mark.parametrize("flags", [
    ["--backend", "fast"], ["--pipeline-depth", "2"],
    # 16 genomes x one 1,000-SNP block: 16,000 bytes over 60% of the budget
    ["--device-budget-bytes", "20000"],
], ids=["backend_fast", "pipeline_depth", "device_budget_bytes"])
def test_fast_flags_match_jax_cli(run_dset, tmp_path, flags):
    """The fast backend's options run through the port's CLI and give the
    JAX CLI's links with the same options (within the fringe of
    tests/test_torch_pipeline.py; a budget that streams the slabs changes
    the LR row order only)."""
    from tests.test_torch_pipeline import assert_lr_within_fringe, assert_sr_within_fringe

    base = ["--aln", str(run_dset / "aln.fa.gz"), "--gbk", str(run_dset / "ref.gbk"),
            "--max-blk-sz", "1000", *flags]
    assert jcli.main(["run", "--dset", str(tmp_path / "jax"), *base]) == 0
    assert tcli.main(["run", "--dset", str(tmp_path / "torch"), *base,
                      "--device", "cpu"]) == 0
    assert_sr_within_fringe(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert_lr_within_fringe(str(tmp_path / "jax"), str(tmp_path / "torch"))
    import json

    fast = json.load(open(tmp_path / "torch" / "timings.json"))["blk5_phases"]["fast"]
    assert fast["depth"] == (2 if "--pipeline-depth" in flags else 4)
    assert fast["streaming"] == ("--device-budget-bytes" in flags)


@pytest.mark.parametrize("flags", [
    ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
    ["--n-devices", "2"], ["--sr-reduce", "part", "--n-devices", "2"],
])
def test_unported_flags_raise(tmp_path, flags, monkeypatch):
    import ldweaver_tpu_torch.pipeline as tpipe

    seen = {}
    monkeypatch.setattr(tpipe, "ldweaver", lambda **kw: seen.update(kw))
    argv = ["run", "--dset", str(tmp_path / "x"), "--aln", "unused.fa",
            "--gbk", "unused.gbk", "--device", "cpu", *flags]
    if "--n-devices" not in flags:  # an incomplete bring-up raises
        with pytest.raises((ValueError, RuntimeError), match="process"):
            tcli.main(argv)
        assert not seen
        return
    assert tcli.main(argv) == 0
    cfg = seen["config"]
    assert cfg.n_devices == 2 and seen["device"] == "cpu"
    assert cfg.sr_reduce == ("part" if "part" in flags else "auto")
