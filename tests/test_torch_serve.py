"""The port's batched server against ``repro.launch.serve``.

Same parameters (the reference's reduced qwen2-0.5b, carried over by
``params_from_jax``) and the same prompts on both sides: the generated
tokens must be equal, request for request.
"""
import numpy as np
import pytest
import torch

from repro.launch import serve as j_serve
from repro_torch.launch import serve as t_serve
from repro_torch.models import transformer as t_tm
from test_torch_lm import _model, _to_jax

torch.set_num_threads(2)


def test_batched_server_matches_reference():
    jcfg, tcfg, np_params = _model("qwen2-0.5b")
    rng = np.random.default_rng(5)
    lens = [12, 9, 7, 10]
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    gen, slots, max_len = 5, 2, 12 + 5 + 4
    jdone = j_serve.BatchedServer(jcfg, _to_jax(np_params), slots=slots,
                                  max_len=max_len).run(
        [j_serve.Request(i, p, gen) for i, p in enumerate(prompts)])
    tdone = t_serve.BatchedServer(
        tcfg, t_tm.params_from_jax(np_params, tcfg, "cpu"), slots=slots,
        max_len=max_len).run(
        [t_serve.Request(i, p, gen) for i, p in enumerate(prompts)])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.generated for r in tdone] == [r.generated for r in jdone]
    assert all(len(r.generated) == gen for r in tdone)


def test_serve_main_needs_the_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["--requests", "1"])


def test_serve_main_on_cpu(capsys):
    done = t_serve.main(["--requests", "3", "--batch", "2", "--prompt-len",
                         "8", "--gen-tokens", "4"], device="cpu")
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.generated) == 4 and r.done for r in done)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
