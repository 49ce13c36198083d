"""CPU tests of chip_smoke.py's device check and numpy oracle, and of
the compile-cache placement it shares with the CLI."""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _python(code_or_args, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *code_or_args], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=300)


class TestCompileCache:
    SNIPPET = ("import jax; from kmer_tpu.cli import enable_compile_cache; "
               "print(enable_compile_cache()); "
               "print(jax.config.jax_compilation_cache_dir)")

    def test_env_var_is_the_cache(self, tmp_path):
        p = _python(["-c", self.SNIPPET],
                    {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        assert p.returncode == 0, p.stderr
        assert p.stdout.split() == [str(tmp_path), str(tmp_path)]

    def test_default_is_inside_the_checkout(self):
        p = _python(["-c", self.SNIPPET], drop=("JAX_COMPILATION_CACHE_DIR",))
        assert p.returncode == 0, p.stderr
        want = os.path.join(REPO, ".jax_cache")
        assert p.stdout.split() == [want, want]


def test_smoke_refuses_a_cpu_only_jax():
    p = _python(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert '"ok"' not in p.stdout


def test_oracle_matches_python_strings():
    codes = np.random.default_rng(4).integers(0, 4, (12, 30), dtype=np.uint8)
    comp = str.maketrans("acgt", "tgca")
    want = collections.Counter()
    for row in codes:
        s = "".join("acgt"[c] for c in row)
        for i in range(30 - 9 + 1):
            km = s[i:i + 9]
            want[min(km, km.translate(comp)[::-1])] += 1
    keys, counts = chip_smoke.oracle_counts(codes, 9, canonical=True)
    got = {"".join("acgt"[(int(v) >> (2 * (8 - j))) & 3] for j in range(9)): int(c)
           for v, c in zip(keys, counts)}
    assert got == dict(want)


@pytest.mark.parametrize("single_shot", [True, False])
def test_oracle_matches_count_file(tmp_path, single_shot):
    from kmer_tpu.pipeline import count_file

    codes = np.random.default_rng(5).integers(0, 4, (300, 150), dtype=np.uint8)
    fq = tmp_path / "reads.fastq"
    fq.write_bytes(chip_smoke.fastq_bytes(codes))
    t = count_file(str(fq), "fastq", 21, canonical=True,
                   single_shot=single_shot).trim()
    counts = t.counts64() if hasattr(t, "counts64") else t.counts
    res = chip_smoke.check_table(
        "count_file", chip_smoke.engine_keys(t.hi, t.lo, 21), counts,
        chip_smoke.oracle_counts(codes, 21), length=t.length)
    assert res["total"] == 300 * (150 - 21 + 1)


def test_check_table_rejects_a_wrong_count():
    codes = np.random.default_rng(6).integers(0, 4, (4, 40), dtype=np.uint8)
    keys, counts = chip_smoke.oracle_counts(codes, 21)
    bad = counts.copy()
    bad[0] += 1
    with pytest.raises(AssertionError, match="counts differ"):
        chip_smoke.check_table("t", keys, bad, (keys, counts))
    assert json.dumps(chip_smoke.check_table("t", keys, counts, (keys, counts)))
