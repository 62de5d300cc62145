"""The run script: no card means no result and a non-zero exit, never a
fall-back to the CPU; nor does it run where the port is absent; and it
takes no notice of ``BENCH_RUN``."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from flowbench import harness, run

CMD = ["--workload", "pwc-stream-sintel", "--seed", str(2 ** 32 + 3),
       "--seconds", "1", "--trace", "0"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_RUN", "anything")
    assert run.main(CMD) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(CMD) != 0
    assert capsys.readouterr().out == ""


def test_negative_seed_is_refused():
    with pytest.raises(SystemExit):
        run.main(["--workload", "pwc-stream-sintel", "--seed", "-1",
                  "--seconds", "1"])


def test_without_the_port_no_result(tmp_path):
    """In a directory of BENCHMARK.json and flowbench/ alone, with a card
    pretended, the run fails for want of the port and prints nothing."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            f"sys.argv = ['flowbench/run.py', *{CMD!r}]\n"
            "runpy.run_path('flowbench/run.py', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert "pwcnet_tpu_torch" in proc.stderr
    assert proc.returncode != 0 and proc.stdout == ""


def test_result_line_puts_the_checks_last():
    cell = harness.resolve("pwc-stream-sintel")
    out = harness.Outcome(attempted=3, failed=0, end_to_end={},
                          checks=[("flow_rel_err", 0.5, 0.1)],
                          memory_peak_bytes=1)
    res = json.loads(harness.result_line(cell, out, {}, {"count": 1}, None))
    assert list(res)[-1] == "checks" and res["correct"] is False
    assert res["checks"]["flow_rel_err"] == {"value": 0.5, "limit": 0.1}
