"""chip_smoke.py's CPU-testable parts: the seeded workload generator,
the output comparison that decides the device-vs-host oracle, and the
genotype report's platform fields, on a tiny graph."""
import gzip
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A 30 kb / 300-site workload, built, and genotyped by both
    engines with the same --seed (one host buffer of reads)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "GENOME_LEN", 30_000)
    mp.setattr(chip_smoke, "NUM_SITES", 300)
    root = tmp_path_factory.mktemp("smoke")
    reads = chip_smoke.make_workload(root, seed=3, n_reads=400)
    chip_smoke.cli("build", "--gram_dir", root / "gram", "--prg",
                   root / "prg", "--ref", root / "ref.fa", "--kmer_size",
                   chip_smoke.KMER_SIZE, "--force")
    reports = {}
    for engine in ("device", "host"):
        _, reports[engine] = chip_smoke.genotype(
            root, root / "reads.fastq", engine, engine, seed=7)
    mp.undo()
    return root, reads, reports


def test_workload_is_seeded(tiny, tmp_path, monkeypatch):
    root, reads, _ = tiny
    monkeypatch.setattr(chip_smoke, "GENOME_LEN", 30_000)
    monkeypatch.setattr(chip_smoke, "NUM_SITES", 300)
    again = chip_smoke.make_workload(tmp_path / "a", seed=3, n_reads=400)
    np.testing.assert_array_equal(again, reads)
    for name in ("prg", "ref.fa", "reads.fastq"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (root / name).read_bytes(), name
    other = chip_smoke.make_workload(tmp_path / "b", seed=4, n_reads=400)
    assert not np.array_equal(other, reads)
    assert reads.shape == (400, chip_smoke.READ_LEN)
    assert reads.min() >= 1 and reads.max() <= 4


def test_reference_is_the_ref_allele_path():
    # [5 A 6 C 6] between flanks: the reference keeps A
    prg = np.array([1, 2, 5, 1, 6, 2, 6, 3, 4, 7, 4, 8, 1, 8, 2])
    np.testing.assert_array_equal(chip_smoke.reference_of(prg),
                                  [1, 2, 1, 3, 4, 4, 2])


def test_device_and_host_outputs_identical(tiny):
    root, _, _ = tiny
    assert chip_smoke.compare_outputs(root / "device", root / "host") == []


def _copy(root, tmp_path):
    dst = tmp_path / "copy"
    shutil.copytree(root / "device", dst)
    return dst


def _rewrite_vcf(d, edit):
    path = d / chip_smoke.VCF
    with gzip.open(path, "rt") as fh:
        lines = fh.readlines()
    with gzip.open(path, "wt") as fh:
        fh.writelines(edit(lines))


def test_compare_ignores_only_file_date(tiny, tmp_path):
    root, _, _ = tiny
    d = _copy(root, tmp_path)
    _rewrite_vcf(d, lambda ls: [("##fileDate=19700101\n"
                                 if l.startswith("##fileDate") else l)
                                for l in ls])
    assert chip_smoke.compare_outputs(root / "device", d) == []


def test_compare_fails_on_changed_vcf_body(tiny, tmp_path):
    root, _, _ = tiny
    d = _copy(root, tmp_path)

    def flip_first_record(lines):
        i = next(j for j, l in enumerate(lines) if not l.startswith("#"))
        cols = lines[i].split("\t")
        cols[1] = str(int(cols[1]) + 1)
        return lines[:i] + ["\t".join(cols)] + lines[i + 1:]

    _rewrite_vcf(d, flip_first_record)
    assert chip_smoke.compare_outputs(root / "device", d) == [chip_smoke.VCF]


def test_compare_fails_on_changed_coverage(tiny, tmp_path):
    root, _, _ = tiny
    d = _copy(root, tmp_path)
    rel = "coverage/allele_sum_coverage"
    (d / rel).write_bytes((d / rel).read_bytes() + b"\n")
    assert chip_smoke.compare_outputs(root / "device", d) == [rel]


def test_report_records_platform_and_device_kind(tiny):
    _, _, reports = tiny
    dev = reports["device"]["processes"]["genotype"]
    assert dev["mapping_engine"] == "device"
    assert dev["platform"] == "cpu"
    assert dev["device_kind"] == "cpu"
    assert dev["device_count"] == 1
    eng = dev["engine"]
    assert eng["device_mapped"] > 0
    assert eng["steady_state_new_shapes"] == 0
    assert eng["first_buffer_seconds"] > 0
    host = reports["host"]["processes"]["genotype"]
    assert (host["mapping_engine"], host["platform"],
            host["device_kind"]) == ("host", "cpu", "host")
    assert "engine" not in host
    # the report is plain JSON all the way down
    json.dumps(reports)


def test_check_genotype_run_holds_platform_and_kind(tiny, monkeypatch):
    root, _, reports = tiny
    monkeypatch.setattr(chip_smoke, "PLATFORM", "cpu")
    proc, eng = chip_smoke.check_genotype_run(root, "device",
                                              reports["device"])
    assert eng["device_mapped"] > 0
    for field, value in (("platform", "gpu"), ("device_kind", "other")):
        bad = json.loads(json.dumps(reports["device"]))
        bad["processes"]["genotype"][field] = value
        with pytest.raises(RuntimeError, match="mapped on"):
            chip_smoke.check_genotype_run(root, "device", bad)
