"""The port's CNN pipeline launcher (``repro_torch.launch.cnn_pipeline``):
the whole pipeline on ``tiny_cnn()`` on the CPU, and its refusal without a
card.  A file of its own, so that this run of the pipeline and the one of
``tests/test_torch_cnn.py``'s ``pipeline`` fixture land on different
workers under ``pytest -n ... --dist loadfile``.
"""
import pytest
import torch

from repro_torch.data import synthetic as tdata
from repro_torch.launch import cnn_pipeline


def test_launcher_runs_on_cpu_and_refuses_without_a_card(capsys, monkeypatch):
    cnn_pipeline.main(["--fragment", "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "=== FORMS pipeline, fragment size 8 ===" and out[-1] == "OK"
    assert any(line.startswith("compressed-tree forward: argmax agreement") for line in out)
    assert any(line.startswith("modeled FPS vs original ISAAC") for line in out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cnn_pipeline.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.image_batch(tdata.ImageStreamConfig(8, 1, 10, 2), 0)
