"""Two faults of the port, repaired, on the CPU.

- Kernels launch on their operands' card: ``Kernel.launch`` enters that
  card's device guard and passes that card's current stream, whichever card
  is current.  The CPU has no card, so ``torch.cuda``'s guard and stream
  are stood in for, and the operands report ``cuda:1`` while card 0 is
  current.
- ``AudioMetrics`` takes the JAX package's parameters in the JAX order
  (then ``device``), and an argument the port cannot honour raises, so
  that one call never returns other keys in the two packages.

- The fused frontend's plain version runs no kernel: its log-mel takes the
  halo log-mel kernel's plain version on any device (it went through
  ``log_mel_halo``, which launches that kernel on a CUDA tensor, so the
  card compared the frontend kernel against a chain holding another
  kernel).  Pinned on the CPU with ``log_mel_halo`` made to raise.

And the planted faults of ``audio_metrics_tpu_torch.plant_faults``, which
show on a card that the smoke's checks fail a wrong kernel: each one's text
occurs exactly once in its source, so that no planted fault is silently
absent when the sources change.
"""

import contextlib
import ctypes
import importlib
import inspect
import re
import types

import numpy as np
import pytest
import torch

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu_torch import AudioMetrics, kernels
from audio_metrics_tpu_torch.plant_faults import FAULTS, ROOT


class _OnCard1(torch.Tensor):
    """A CPU tensor that reports ``cuda:1`` as its device."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.fixture
def cards(monkeypatch):
    """torch.cuda's device guard and streams stood in for: card 0 is
    current; the log holds what ``launch`` entered and asked for."""
    log = {"current": 0, "guards": [], "streams": [], "called_on": []}

    @contextlib.contextmanager
    def device(dev):
        old, log["current"] = log["current"], torch.device(dev).index
        log["guards"].append(log["current"])
        try:
            yield
        finally:
            log["current"] = old

    class Stream:
        def __init__(self, index):
            self.cuda_stream = 1000 + index

    def current_stream(dev=None):
        index = log["current"] if dev is None else torch.device(dev).index
        log["streams"].append(index)
        return Stream(index)

    def entry(*cargs):
        log["called_on"].append((log["current"], cargs[-1].value))
        return 0

    class Lib:
        am_test = staticmethod(entry)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(kernels, "build", lambda: Lib())
    return log


def test_launch_takes_the_operands_card_and_its_stream(cards):
    x = torch.Tensor._make_subclass(_OnCard1, torch.zeros(4))
    kernels.Kernel("test", "-", "-").launch("am_test", 3, x, 1.5, x)
    assert cards["guards"] == [1]
    assert cards["streams"] == [1]
    # the entry point ran inside card 1's guard, on card 1's stream
    assert cards["called_on"] == [(1, 1001)]
    assert cards["current"] == 0


def test_launch_raises_on_a_kernel_error(cards, monkeypatch):
    class Lib:
        am_test = staticmethod(lambda *cargs: 700)

    monkeypatch.setattr(kernels, "build", lambda: Lib())
    x = torch.Tensor._make_subclass(_OnCard1, torch.zeros(4))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kernels.Kernel("test", "-", "-").launch("am_test", x)


def test_constructor_has_the_jax_parameters_in_order():
    jax_names = list(inspect.signature(JaxAudioMetrics.__init__).parameters)
    port_names = list(inspect.signature(AudioMetrics.__init__).parameters)
    assert port_names == jax_names + ["device"]
    jax_defaults = {k: p.default for k, p in
                    inspect.signature(JaxAudioMetrics.__init__).parameters.items()}
    port_defaults = {k: p.default for k, p in
                     inspect.signature(AudioMetrics.__init__).parameters.items()}
    assert list(port_defaults["metrics"]) == list(jax_defaults["metrics"]) == ["apa", "fad"]
    for k in jax_names[2:]:
        assert port_defaults[k] == jax_defaults[k], k


class _Embedder:
    device = torch.device("cpu")


@pytest.mark.parametrize("kwargs,match", [
    (dict(metrics=["fad"], dcn_slices=2), r"1 devices do not divide into 2 DCN slices"),
    (dict(metrics=["fad"], device_indices=[0, 0]), r"device_indices \[0, 0\] name a device"),
])
def test_unported_arguments_raise(kwargs, match):
    """``device_indices`` and ``dcn_slices`` are ported (multi-GPU): what
    raises now is a mesh they cannot make, as in the JAX package: one CPU
    shard in 2 DCN slices, a device named twice."""
    with pytest.raises(ValueError, match=match):
        AudioMetrics(embedder=_Embedder(), device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,need_apa,stems_mode,mix", [
    (dict(), True, True, "L0"),
    (dict(metrics=["kd", "apa"]), True, True, "L0"),
    (dict(metrics=["fad"], mix_function="L2"), False, True, "L2"),
    (dict(metrics=["fad", "fad_inf"]), False, True, "L0"),
])
def test_apa_arguments_build(kwargs, need_apa, stems_mode, mix):
    """The arguments that the port refused before APA and ``fad_inf`` were
    ported: the default metrics, APA among others, a named mix,
    ``fad_inf``; the flags and the registry mix the JAX package sets for
    them (``fad_inf`` stores the stem embeddings, as its
    ``_need_embeddings`` says).  A metric of no name raises."""
    from audio_metrics_tpu_torch.ops.mix import MIX_FUNCTIONS

    am = AudioMetrics(embedder=_Embedder(), device="cpu", **kwargs)
    assert (am.need_apa, am.stems_mode, am.mix_function) == (need_apa, stems_mode,
                                                             MIX_FUNCTIONS[mix])
    assert (am.mix_reference is not None) == need_apa and am.stem_reference is not None
    assert am.store_stem_embeddings == any(m in ("kd", "prdc", "fad_inf")
                                           for m in am.metrics)
    with pytest.raises(ValueError, match="unknown metric 'fad_infinity'"):
        AudioMetrics(embedder=_Embedder(), device="cpu", metrics=["fad", "fad_infinity"])


def test_ported_arguments_at_their_defaults_build():
    am = AudioMetrics(["fad", "kd"], None, None, _Embedder(), None, 5.0, None, None, 32, False,
                      None, "cpu")
    assert am.metrics == ["fad", "kd"] and am.win_dur == 5.0 and am.batch_size == 32


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_planted_fault_occurs_once_in_its_source(name):
    path, text, replacement, _ = FAULTS[name]
    assert text != replacement
    assert (ROOT / path).read_text().count(text) == 1


def _planted(name: str):
    """The module of fault ``name``'s source with the fault planted,
    loaded beside the real one (its relative imports are the real
    package's)."""
    path, text, replacement, _ = FAULTS[name]
    src = (ROOT / path).read_text()
    assert src.count(text) == 1
    modname = path[: -len(".py")].replace("/", ".")
    mod = types.ModuleType(f"{modname}_{name}")
    mod.__package__, mod.__file__ = modname.rpartition(".")[0], str(ROOT / path)
    exec(compile(src.replace(text, replacement), mod.__file__, "exec"), mod.__dict__)
    return mod


def _first_check(name: str):
    """The first check that runs the code of fault ``name``
    (``plant_faults.CPU_FAULTS``), as a callable on the planted module."""
    import test_torch_apa as apa
    import test_torch_cli as cli
    import test_torch_embedder_protocol as protocol
    import test_torch_fad_inf as fad_inf
    import test_torch_hostfed as hostfed
    import test_torch_loudness as loudness
    import test_torch_options as options
    import test_torch_sharding as sharding
    import test_torch_surface as surface
    import test_torch_tail as tail
    import test_torch_vggish as vggish

    return {
        "V1": lambda mod: vggish.check_vggish_f32(mod.VGGish, vggish.seeded_params(),
                                                  vggish.seeded_patches()),
        "H1": lambda mod: options.check_hop_windows(mod.embedding_pipeline),
        "P2": lambda mod: options.check_precompile_restores(mod.AudioMetrics),
        "D1": apa.check_pair_pipeline,
        "U1": loudness.check_loudness,
        "K1": loudness.check_limiter,
        "A2": lambda mod: loudness.check_apa_formula(mod._apa),
        "F2": lambda mod: fad_inf.check_fad_inf_parts(mod.fad_inf_parts),
        "S3": lambda mod: hostfed.check_shuffle(mod.shuffle_stream),
        "W2": lambda mod: cli.check_riff_size(mod.write_wav),
        "S4": lambda mod: sharding.check_fused_loop(mod.sharded_embed_loop),
        "S5": lambda mod: sharding.check_stats_sweep(mod.sharded_pairwise_stats),
        "S6": sharding.check_kd_sharded,
        "C1": lambda mod: protocol.check_clap_crops(mod.LaionCLAP),
        "M1": lambda mod: surface.check_pending_stats(mod.AudioMetricsData),
        "M2": lambda mod: surface.check_iadd_adopts_flag(mod.AudioMetricsData),
        "F3": lambda mod: surface.check_ns_method(mod.frechet_distance),
        "E1": lambda mod: tail.check_kd_lazy(mod.kernel_distance),
        "E2": tail.check_worker_error,
        "E3": tail.check_one_pull,
    }[name]


@pytest.mark.parametrize("name", ["V1", "H1", "P2", "D1", "U1", "K1", "A2", "F2", "S3", "W2",
                                  "S4", "S5", "S6", "C1", "M1", "M2", "F3", "E1", "E2",
                                  "E3"])
def test_planted_python_fault_fails_its_first_check(name):
    """V1 (VGGish flattens NCHW) fails the f32 net against the JAX forward,
    H1 (the pipeline ignores ``hop_dur``) the windows against the JAX
    package's, P2 (``precompile`` leaves the projection refitted) the state
    after ``precompile``; D1 (a plain permutation for the derangement) the
    misaligned set against the JAX package's at the same seed, U1 (the
    relative gate without its -10 LU) the loudness against the JAX
    function's, K1 (the limiter's delay one sample long) the limiter
    against the JAX one, A2 (APA's denominator without |numerator|) the
    formula's golden cases; F2 (FAD-inf fitted against the subset size)
    the sweep against the JAX function, S3 (the window shuffle protects
    min_age - 1 insertions) the order against the JAX copy's, W2 (the RIFF
    size 4 bytes too large) the size check; S4 (a shard's block of windows
    one late) the sharded embeddings against one device's, S5 (PRDC's
    counts the shards' max) and S6 (KD keeps a shard's subsets twice) the
    sharded sweep and KD against one device's; C1 (the crop's offset one
    off) the crops against the JAX ones, M1 (``mean`` without the pending
    merge) the stats of queued moments, M2 (``+=`` without the adopted
    flag) the merge into an empty accumulator, F3 (the NS method at
    ``AM_TPU_FAD_NS_ITERS``) the method under that variable; E1
    (``kernel_distance`` drops ``lazy``) its return types against the JAX
    function's, E2 (the FAD thread's exception swallowed) the exception
    at the caller, E3 (FAD-inf's arrays pulled on their own) the one pull
    of the evaluate.  The same checks pass on the
    real modules (their own tests in tests/test_torch_vggish.py,
    tests/test_torch_options.py, tests/test_torch_apa.py,
    tests/test_torch_loudness.py, tests/test_torch_fad_inf.py,
    tests/test_torch_hostfed.py, tests/test_torch_cli.py,
    tests/test_torch_sharding.py, tests/test_torch_embedder_protocol.py,
    tests/test_torch_surface.py and tests/test_torch_tail.py)."""
    from audio_metrics_tpu_torch.plant_faults import CPU_FAULTS

    assert name in CPU_FAULTS
    with pytest.raises(AssertionError):
        _first_check(name)(_planted(name))


@pytest.mark.parametrize("tool", ["profile_evaluate", "profile_window_attn", "plant_faults"])
def test_card_tools_exit_nonzero_without_a_card(monkeypatch, tool):
    """The measurement and fault tools fail where no card is: none of them
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"audio_metrics_tpu_torch.{tool}").main
    assert main([]) != 0


def test_frontend_plain_version_calls_no_kernel_wrapper(monkeypatch):
    from audio_metrics_tpu_torch.models.clap import ClapFrontend
    from audio_metrics_tpu_torch.models.htsat import HTSATConfig, init_params
    from audio_metrics_tpu_torch.ops import mel
    from audio_metrics_tpu_torch.ops.frontend_fused import clap_tokens_fused_plain

    def wrapper(*args, **kwargs):
        raise AssertionError("the plain chain called the halo log-mel kernel's wrapper")

    monkeypatch.setattr(mel, "log_mel_halo", wrapper)
    cfg = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    fr = ClapFrontend(init_params(cfg, seed=0), cfg)
    audio = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 240000)).astype(np.float32))
    tokens = clap_tokens_fused_plain(0.2 * audio, fr, sr=48000, cfg=cfg)
    assert tokens.shape == (1, cfg.grid_size ** 2, cfg.embed_dim)
    assert tokens.dtype == torch.bfloat16 and bool(torch.isfinite(tokens.float()).all())


# ----------------------------------------------------------------------
# f32 on the card: the f32 kernels of the whole block, the merge, the split
# halves and the opt-in ops; no cast, no plain version; f16 raises.  And the
# bf16 split halves on the operands held from load, raising without them
# ----------------------------------------------------------------------
class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on card 0."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


class _Calls(list):
    """The C entry points called, in order; ``args[name]``: the pointer
    values passed to the last call of ``name``, ``cargs[name]``: all its
    ctypes arguments."""

    def __init__(self):
        super().__init__()
        self.args, self.cargs = {}, {}


@pytest.fixture
def symbols(cards, monkeypatch):
    """The card stood in for as in ``cards``: the library records the C
    entry points called and their pointer arguments, and scratch is
    allocated on the CPU."""
    called = _Calls()

    class Lib:
        def __getattr__(self, name):
            def entry(*cargs):
                called.append(name)
                called.args[name] = [a.value for a in cargs if isinstance(a, ctypes.c_void_p)]
                called.cargs[name] = cargs
                return 0
            return entry

    empty = torch.empty

    def empty_on_cpu(*shape, dtype=None, device=None):
        return empty(*shape, dtype=dtype)

    monkeypatch.setattr(kernels, "build", lambda: Lib())
    monkeypatch.setattr(torch, "empty", empty_on_cpu)
    return called


def _on_card(module):
    for name, buf in list(module.named_buffers()):
        module._buffers[name] = _card(buf)
    return module


def _small_stage1(dtype, attention="v4"):
    """Stage 1 of the small config (C = 64, 2 heads, R = 32, shifted):
    a Swin block and the merge after it, buffers on the stand-in card."""
    from audio_metrics_tpu_torch.models.htsat import HTSATConfig, PatchMerge, SwinBlock, init_params

    cfg = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    p = init_params(cfg, seed=0)
    block = SwinBlock(p, "audio_encoder.layers.1.blocks.1", cfg, 32, 4, 2, dtype,
                      attention=attention)
    merge = PatchMerge(p, "audio_encoder.layers.1.downsample", cfg, 32, dtype)
    x = _card(torch.zeros((2, 32 * 32, 64), dtype=dtype))
    return _on_card(block), _on_card(merge), x


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, ["am_swin_block_f32", "am_patch_merge_f32"]),
    (torch.bfloat16, ["am_swin_block", "am_patch_merge"]),
])
def test_card_dtype_reaches_its_kernel(symbols, dtype, want):
    """An f32 tensor on the card launches the f32 kernels, a bf16 one the
    bf16 kernels, each counted on its own entry; the output keeps the
    activation dtype (no cast)."""
    from audio_metrics_tpu_torch.kernels import KERNELS

    block, merge, x = _small_stage1(dtype)
    names = ("swin_block_f32", "patch_merge_f32") if dtype == torch.float32 else \
        ("swin_block", "patch_merge")
    before = {k: v.launches for k, v in KERNELS.items()}
    y = block(x)
    z = merge(y)
    assert symbols == want
    assert y.dtype == z.dtype == dtype and z.shape == (2, 16 * 16, 128)
    after = {k: v.launches for k, v in KERNELS.items()}
    assert {k for k in after if after[k] != before[k]} == set(names)
    assert all(after[k] == before[k] + 1 for k in names)


def _counted(fn):
    """``fn()`` and the kernels whose launch count it moved, by how much."""
    from audio_metrics_tpu_torch.kernels import KERNELS

    before = {k: v.launches for k, v in KERNELS.items()}
    out = fn()
    return out, {k: v.launches - before[k] for k, v in KERNELS.items()
                 if v.launches != before[k]}


@pytest.mark.parametrize("attention", ["v3", "v1"])
def test_card_f32_split_block_reaches_its_f32_kernels(symbols, attention):
    """An f32 v3 or v1 block on the card launches the f32 attention half,
    then the f32 fused MLP (stage 1 at 2 images: 2048 rows of 1024 tokens),
    each once and no bf16 kernel, reading the (2, N, K) stacks split at
    load, and returns f32 (no cast)."""
    from audio_metrics_tpu_torch.ops.tf32 import tf32_split

    block, _, x = _small_stage1(torch.float32, attention)
    ops = block.kernel_operands()
    c = x.shape[-1]
    assert ops["wqkv_t"].shape == (2, 3 * c, c) and ops["wp_t"].shape == (2, c, c)
    assert ops["w1_t"].shape == (2, 4 * c, c) and ops["w2_t"].shape == (2, c, 4 * c)
    assert torch.equal(ops["w1_t"], tf32_split(block.w1.t()))
    y, moved = _counted(lambda: block(x))
    attn = f"am_swin_attn_{attention}_f32"
    assert symbols == [attn, "am_swin_mlp_f32"]
    assert moved == {f"swin_attn_{attention}_f32": 1, "swin_mlp_f32": 1}
    for name in ("wqkv_t", "wp_t"):
        assert ops[name].data_ptr() in symbols.args[attn]
    for name in ("w1_t", "w2_t"):
        assert ops[name].data_ptr() in symbols.args["am_swin_mlp_f32"]
    assert y.dtype == torch.float32 and y.shape == x.shape
    with pytest.raises(NotImplementedError):  # f16 has no kernel
        block(x.half())
    assert symbols == [attn, "am_swin_mlp_f32"]


@pytest.mark.parametrize("attention", ["v3", "v1"])
def test_card_bf16_split_block_reaches_its_kernels(symbols, attention):
    """A bf16 v3 or v1 block on the card launches its bf16 attention half,
    then the bf16 fused MLP, each once and no other kernel; each reads the
    operands held from load (the whole block's transposed matrices and
    column sums for v3, v1's transposed side-by-side matrices and qkv bias,
    the MLP's transposed ``w1``, ``w2``); bf16 out."""
    block, _, x = _small_stage1(torch.bfloat16, attention)
    ops = block.kernel_operands()
    y, moved = _counted(lambda: block(x))
    attn = f"am_swin_attn_{attention}"
    assert symbols == [attn, "am_swin_mlp"]
    assert moved == {f"swin_attn_{attention}": 1, "swin_mlp": 1}
    for name in ("w1_t", "w2_t"):
        assert ops[name].data_ptr() in symbols.args["am_swin_mlp"]
    held = {"v3": ("wqkv_t", "wp_t", "csum"), "v1": ("wqkv_t", "wp_t", "bq3")}[attention]
    for name in held:
        assert ops[name].data_ptr() in symbols.args[attn]
    assert y.dtype == torch.bfloat16 and y.shape == x.shape


def test_card_bf16_split_halves_raise_without_operands(symbols):
    """A bf16 tensor on the card without the operands made at load raises
    ``ValueError`` naming their maker at the v3 half's and the fused MLP's
    wrappers, and launches nothing: no fallback to a plain version."""
    from audio_metrics_tpu_torch.ops.attention import swin_attention_half_v3
    from audio_metrics_tpu_torch.ops.mlp import mlp_block

    block, _, x = _small_stage1(torch.bfloat16, "v3")
    geo = dict(heads=block.heads, window=block.window, shift=block.shift, eps=block.eps)
    with pytest.raises(ValueError, match=r"swin_block_operands\(wqkv, wp, w1, w2\)"):
        swin_attention_half_v3(x.view(2, 32, 32, 64), block.wqkv, block.bq3, block.wp, block.bp,
                               block.bm, **geo)
    with pytest.raises(ValueError, match=r"mlp_operands\(w1, w2\)"):
        mlp_block(x, block.ln2_w, block.ln2_b, block.w1, block.b1, block.w2, block.b2,
                  eps=block.eps)
    assert symbols == []


@pytest.mark.parametrize("half,name,wrong", [
    ("mlp", "w1_t", lambda b, o: o["w2_t"]),  # another matrix's shape
    ("mlp", "w2_t", lambda b, o: b.w2),  # not transposed
    ("v3", "wqkv_t", lambda b, o: b.wqkv),  # not transposed
    ("v3", "wp_t", lambda b, o: o["wp_t"][:32, :32].contiguous()),  # another width's
    ("v3", "csum", lambda b, o: o["csum"][:64].contiguous()),
], ids=["mlp-w1_t", "mlp-w2_t", "v3-wqkv_t", "v3-wp_t", "v3-csum"])
def test_card_bf16_split_halves_check_operand_shapes(symbols, half, name, wrong):
    """A bf16 split half on the card raises ``ValueError`` naming the
    operand when one of the operands it reads has another shape than the
    maker gives at this width, and launches nothing."""
    from audio_metrics_tpu_torch.ops.attention import swin_attention_half_v3
    from audio_metrics_tpu_torch.ops.mlp import mlp_block

    block, _, x = _small_stage1(torch.bfloat16, "v3")
    ops = block.kernel_operands()
    ops = dict(ops, **{name: wrong(block, ops)})
    with pytest.raises(ValueError, match=name):
        if half == "mlp":
            mlp_block(x, block.ln2_w, block.ln2_b, block.w1, block.b1, block.w2, block.b2,
                      eps=block.eps, operands=ops)
        else:
            swin_attention_half_v3(x.view(2, 32, 32, 64), block.wqkv, block.bq3, block.wp,
                                   block.bp, block.bm, heads=block.heads, window=block.window,
                                   shift=block.shift, eps=block.eps, operands=ops)
    assert symbols == []


def _ln_affine_half(half):
    """The small config's stage-1 v1 block, or its weights in v2's layout,
    bf16, on the stand-in card: the v1 or v2 attention half as a call of
    (x, operands) and the operands its kernel reads, made at load."""
    from audio_metrics_tpu_torch.models.htsat import (
        HTSATConfig, _Folded, _v2_kernel_weights, init_params,
    )
    from audio_metrics_tpu_torch.ops.attention import (
        half_operands, swin_attention_half_v1, swin_attention_half_v2,
    )

    geo = dict(heads=2, window=8, shift=4, eps=1e-5)
    if half == "v1":
        b, _, _ = _small_stage1(torch.bfloat16, "v1")
        args = (b.ln1_w, b.ln1_b, b.wq, b.bq, b.wk, b.wv, b.wp, b.bp, b.bm)
        return (lambda x, **o: swin_attention_half_v1(x, *args, **geo, **o)), b.kernel_operands()
    cfg = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    w = _on_card(_Folded(_v2_kernel_weights(init_params(cfg, seed=0),
                                            "audio_encoder.layers.1.blocks.1", 32, 4, 2, 8),
                         torch.bfloat16))
    args = (w.ln1_w, w.ln1_b, w.wqkv, w.bq3, w.wp, w.bp, w.bm)
    return ((lambda x, **o: swin_attention_half_v2(x, *args, **geo, **o)),
            {k: _card(v) for k, v in half_operands(w.wqkv, w.wp).items()})


@pytest.mark.parametrize("half", ["v1", "v2"])
def test_card_bf16_ln_affine_half_reaches_its_kernel(symbols, half):
    """A bf16 v1 or v2 attention half on the card launches its bf16 kernel
    once on the K-major operands made at load, and bf16 comes out; without
    them it raises ``ValueError`` naming their maker and launches nothing:
    no fallback to a plain version or to another core."""
    call, ops = _ln_affine_half(half)
    x = _card(torch.zeros((2, 32, 32, 64), dtype=torch.bfloat16))
    maker = {"v1": r"v1_operands\(wq, bq, wk, wv, wp\)", "v2": r"half_operands\(wqkv, wp\)"}
    with pytest.raises(ValueError, match=maker[half]):
        call(x)
    assert symbols == []
    y, moved = _counted(lambda: call(x, operands=ops))
    want = f"am_swin_attn_{half}"
    assert symbols == [want] and moved == {want[3:]: 1}
    for name in ("wqkv_t", "wp_t"):
        assert ops[name].data_ptr() in symbols.args[want]
    assert y.dtype == torch.bfloat16 and y.shape == x.shape


@pytest.mark.parametrize("half,name,wrong", [
    ("v1", "wqkv_t", lambda o: o["wqkv_t"].t().contiguous()),  # not transposed
    ("v1", "wp_t", lambda o: o["wp_t"][:32, :32].contiguous()),  # another width's
    ("v1", "bq3", lambda o: o["bq3"][:64].contiguous()),
    ("v2", "wqkv_t", lambda o: torch.stack([o["wqkv_t"]] * 2).float()),  # the f32 stack's shape
    ("v2", "wp_t", lambda o: o["wqkv_t"]),  # another matrix's shape
], ids=["v1-wqkv_t", "v1-wp_t", "v1-bq3", "v2-wqkv_t", "v2-wp_t"])
def test_card_bf16_ln_affine_half_checks_operand_shapes(symbols, half, name, wrong):
    """A bf16 v1 or v2 half on the card raises ``ValueError`` naming the
    operand when one it reads has another shape than its maker gives at
    this width, and launches nothing."""
    call, ops = _ln_affine_half(half)
    x = _card(torch.zeros((2, 32, 32, 64), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=name):
        call(x, operands=dict(ops, **{name: _card(wrong(ops))}))
    assert symbols == []


def _merged_small_half(dtype=torch.bfloat16):
    """A merged v1 half of ``dtype`` on the stand-in card (stage 2 of the small
    config: R = 16, window 16, 4 heads of 32): the call on zero rows, the
    block's held operands and its table."""
    from audio_metrics_tpu_torch.models.htsat import HTSATConfig, SwinBlock, init_params
    from audio_metrics_tpu_torch.ops.attention import swin_attention_half_v1

    cfg = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    block = _on_card(SwinBlock(init_params(cfg, seed=0), "audio_encoder.layers.2.blocks.1", cfg,
                               16, 4, 4, dtype, attention="merged"))
    args = (block.ln1_w, block.ln1_b, block.wq, block.bq, block.wk, block.wv, block.wp, block.bp,
            block.bm)
    x = _card(torch.zeros((2, 16, 16, 128), dtype=dtype))

    def call(operands):
        return swin_attention_half_v1(x, *args, heads=4, window=16, shift=4, operands=operands)

    return call, block.kernel_operands(), block.bm


@pytest.mark.parametrize("dtype,symbol", [(torch.bfloat16, "am_swin_attn_v1"),
                                          (torch.float32, "am_swin_attn_v1_f32")])
def test_card_merged_half_passes_its_live_lists(symbols, dtype, symbol):
    """A merged v1 half (stage 2 of the small config: R = 16, window 16,
    4 heads of 32) on the card launches its entry once, counted on its
    merged kernel, with the live-tile lists held from load and their length
    in the entry's ``live`` and ``nlive`` (8 at this table) and window 16;
    lists that do not fit the table (another head count, no tile, int64)
    raise ``ValueError`` before any launch."""
    call, ops, _ = _merged_small_half(dtype)
    out, moved = _counted(lambda: call(ops))
    assert symbols == [symbol] and moved == {f"swin_attn_v1_merged{symbol[15:]}": 1}
    assert out.dtype == dtype and out.shape == (2, 16, 16, 128)
    params = _c_parameters("audio_metrics_tpu_torch/kernels/csrc/swin_block.cu", symbol)
    cargs = symbols.cargs[symbol]
    assert [type(a) for a in cargs] == [kind for kind, _ in params]
    got = {name: a.value for (_, name), a in zip(params, cargs)}
    assert got["live"] == ops["live"].data_ptr() and got["nlive"] == 8 and got["win"] == 16
    for wrong in (ops["live"][:, :2].contiguous(), ops["live"][..., :0].contiguous(),
                  ops["live"].long()):
        with pytest.raises(ValueError, match="live-tile lists"):
            call(dict(ops, live=_card(wrong)))
    assert symbols == [symbol]


@pytest.mark.parametrize("wrong", ["descending", "repeated", "past-31", "another-table"])
def test_card_merged_half_refuses_lists_not_of_its_table(symbols, wrong):
    """Lists of the table's shape and dtype that are not its map (order
    reversed, a tile listed twice, a tile past 31, the map of the table
    with its keys rolled by one tile) raise ``ValueError`` before any
    launch: the kernel would read them as they are."""
    from audio_metrics_tpu_torch.ops.attention import merged_live_tiles

    call, ops, bm = _merged_small_half()
    live = ops["live"].clone()
    if wrong == "descending":
        live = live.flip(-1).contiguous()
    elif wrong == "repeated":
        live[..., 1] = live[..., 0]
    elif wrong == "past-31":
        live[..., -1] = 32
    else:
        live = merged_live_tiles(bm.roll(8, dims=-1))
    assert live.shape == ops["live"].shape and not torch.equal(live, ops["live"])
    with pytest.raises(ValueError, match="not those of the table"):
        call(dict(ops, live=live))
    assert symbols == []


def test_card_merged_half_checks_its_lists_once(symbols, monkeypatch):
    """The held lists are checked against the table's map at the first
    call, and neither is made or checked again while both keep their
    values; lists changed in place after that raise at the next call, and
    a table changed in place has its map made anew."""
    from audio_metrics_tpu_torch.ops import attention

    call, ops, bm = _merged_small_half()
    call(ops)
    made, equal = [], torch.equal
    real = attention.merged_live_tiles
    monkeypatch.setattr(attention, "merged_live_tiles", lambda t: made.append(t) or real(t))
    monkeypatch.setattr(torch, "equal", lambda *a: pytest.fail("the lists were checked again"))
    call(ops)
    call(dict(ops))
    assert made == [] and symbols == ["am_swin_attn_v1"] * 3
    monkeypatch.setattr(torch, "equal", equal)
    ops["live"][0, 0, 0, 0] = 31
    with pytest.raises(ValueError, match="not those of the table"):
        call(ops)
    assert made == [] and len(symbols) == 3
    ops["live"][0, 0, 0, 0] = real(bm)[0, 0, 0, 0]
    bm.add_(0.0)
    call(ops)
    assert len(made) == 1 and len(symbols) == 4


@pytest.mark.parametrize("op", ["v2", "int8"])
def test_card_f32_opt_in_op_reaches_its_f32_kernel(symbols, op):
    """In f32 the v2 attention half launches ``am_swin_attn_v2_f32`` on the
    (2, N, K) stacks of ``half_operands`` (and raises without them), the
    int8 MLP ``am_swin_mlp_int8_f32``; one launch each, f32 out."""
    from audio_metrics_tpu_torch.models.htsat import (
        HTSATConfig, _Folded, _mlp_weights, _v2_kernel_weights, init_params,
    )
    from audio_metrics_tpu_torch.ops.attention import half_operands, swin_attention_half_v2
    from audio_metrics_tpu_torch.ops.mlp import mlp_block_int8

    cfg = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    p = init_params(cfg, seed=0)
    pre = "audio_encoder.layers.1.blocks.1"
    if op == "v2":
        w = _on_card(_Folded(_v2_kernel_weights(p, pre, 32, 4, 2, 8), torch.float32))
        args = (w.ln1_w, w.ln1_b, w.wqkv, w.bq3, w.wp, w.bp, w.bm)
        geo = dict(heads=2, window=8, shift=4, eps=1e-5)
        x = _card(torch.zeros((2, 32, 32, 64)))
        with pytest.raises(ValueError, match="half_operands"):
            swin_attention_half_v2(x, *args, **geo)
        ops = {k: _card(v) for k, v in half_operands(w.wqkv, w.wp).items()}
        y, moved = _counted(lambda: swin_attention_half_v2(x, *args, **geo, operands=ops))
        want = "am_swin_attn_v2_f32"
        assert ops["wqkv_t"].data_ptr() in symbols.args[want]
    else:
        m = _on_card(_Folded(_mlp_weights(p, pre), torch.float32))
        x = _card(torch.zeros((2, 32 * 32, 64)))
        y, moved = _counted(lambda: mlp_block_int8(x, m.ln2_w, m.ln2_b, m.w1, m.b1, m.w2, m.b2))
        want = "am_swin_mlp_int8_f32"
    assert symbols == [want]
    assert moved == {want[3:]: 1}
    assert y.dtype == torch.float32 and y.shape == x.shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_card_int8_mlp_reads_held_operands(symbols, dtype):
    """The int8 MLP on the card launches its kernel of the activation dtype
    once on the codes and scales held from load (their pointers reach the
    kernel), and raises ``ValueError`` without launching on held operands
    of another width."""
    from audio_metrics_tpu_torch.models.htsat import (
        HTSATConfig, _Folded, _mlp_weights, init_params,
    )
    from audio_metrics_tpu_torch.ops.mlp import mlp_block_int8, mlp_int8_operands

    cfg = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    pre = "audio_encoder.layers.1.blocks.1"
    m = _on_card(_Folded(_mlp_weights(init_params(cfg, seed=0), pre), torch.float32))
    args = (m.ln2_w, m.ln2_b, m.w1, m.b1, m.w2, m.b2)
    ops = {k: _card(v) for k, v in mlp_int8_operands(m.w1, m.w2).items()}
    x = _card(torch.zeros((2, 32 * 32, 64), dtype=dtype))
    with pytest.raises(ValueError, match="q2t"):
        mlp_block_int8(x, *args, operands=dict(ops, q2t=ops["q1t"]))
    assert symbols == []
    y, moved = _counted(lambda: mlp_block_int8(x, *args, operands=ops))
    want = "am_swin_mlp_int8" + ("_f32" if dtype == torch.float32 else "")
    assert symbols == [want] and moved == {want[3:]: 1}
    for name in ("q1t", "s1", "q2t", "s2"):
        assert ops[name].data_ptr() in symbols.args[want]
    assert y.dtype == dtype and y.shape == x.shape


def test_card_f16_raises(symbols):
    """A dtype that has no kernel raises, f16 included."""
    block, merge, x = _small_stage1(torch.float32)
    with pytest.raises(NotImplementedError):
        block(x.half())
    with pytest.raises(NotImplementedError):
        merge(x.half())
    assert symbols == []


def test_f32_forward_calls_no_bf16_wrapper(monkeypatch):
    """The f32 CLAP forward takes the f32 mel chain (PyTorch ops, the JAX
    package's XLA path), never a bf16 kernel's wrapper, and runs every
    Swin block and merge in f32."""
    from audio_metrics_tpu_torch.models import clap, htsat
    from audio_metrics_tpu_torch.models.htsat import HTSATConfig
    from audio_metrics_tpu_torch.ops import mel

    def wrapper(*args, **kwargs):
        raise AssertionError("the f32 forward called a bf16 kernel's wrapper")

    for mod, name in ((mel, "log_mel_halo"), (mel, "log_mel_v1"),
                      (clap, "clap_tokens_fused")):
        monkeypatch.setattr(mod, name, wrapper)
    dtypes = []
    for name in ("swin_block", "patch_merge"):
        orig = getattr(htsat, name)
        monkeypatch.setattr(htsat, name, lambda x, *a, _o=orig, **k: (
            dtypes.append(x.dtype), _o(x, *a, **k))[1])
    cfg = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    emb = clap.LaionCLAP(cfg=cfg, allow_random_weights=True, device="cpu")
    for n in (5 * 48000, 7 * 48000):  # the tiled repeat-pad mel, the padded 10 s one
        audio = torch.from_numpy(np.random.default_rng(n).normal(size=(1, n)).astype(np.float32))
        out = emb.embed(0.1 * audio)
        assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert dtypes == [torch.float32] * 22


def _c_parameters(source, symbol):
    """(ctypes type, name) of each parameter of ``extern "C" int symbol(...)``
    in ``source``: a pointer or the stream c_void_p, a float c_float, an int
    c_int (``kernels._arg``'s mapping)."""
    text = (ROOT / source).read_text()
    params = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*{{', text, re.S).group(1)
    out = []
    for param in (" ".join(p.split()) for p in params.split(",")):
        kind = (ctypes.c_void_p if "*" in param or param.startswith("cudaStream_t")
                else ctypes.c_float if param.startswith("float ") else ctypes.c_int)
        out.append((kind, param.replace("*", " ").split()[-1]))
    return out


@pytest.mark.parametrize("name,symbol,want", [
    # 1 s CLAP clips (101 frames) at hop 480: hop rows, a (k, frame, clip) map
    ("log_mel", "am_log_mel", dict(n=48000, half=512, k_pad=1024, n_frames=101, batch=2,
                                   hop=480, clip_stride=49024, box_k=64, box_rows=128,
                                   box_b=1, n_keep=384, n_mels=64, out_bf16=0,
                                   hop_length=480)),
    # the same clips through the v1 kernel: one run of 202 frame rows
    ("log_mel_v1", "am_log_mel_v1", dict(n=48000, half=512, k_pad=1024, rows=202, one=1,
                                         row_stride=1024, batch_stride=202 * 1024, box_k=64,
                                         box_rows=128, box_b=1, n_keep=384, n_mels=64,
                                         out_bf16=0, batch=2, n_frames=101, hop=480,
                                         frame_length=1024)),
])
def test_card_log_mel_arguments_match_the_c_entry(symbols, monkeypatch, name, symbol, want):
    """A log-mel on a CUDA tensor launches its C entry once with an argument
    of the entry's type in every place (ctypes passes what it is given, so a
    slip in the order would reach the card as a wrong size), the values of
    its frame map there; at 128 mels once more, with n_mels 128 there, the
    filterbank in two groups of 64 and an output of 128 columns."""
    from audio_metrics_tpu_torch.kernels import KERNELS
    from audio_metrics_tpu_torch.ops import mel

    tables = mel._kernel_tables
    monkeypatch.setattr(mel, "_kernel_tables", lambda *a: tuple(
        _card(t) if isinstance(t, torch.Tensor) else t for t in tables(*a[:-1], "cpu")))
    kw = dict(frame_length=1024, hop_length=480, n_fft=1024)
    fn = mel.log_mel_halo if name == "log_mel" else mel.log_mel_v1
    audio = _card(torch.zeros((2, 48000)))
    fb = mel.mel_filter_bank(513, 64, 50.0, 14000.0, 48000, norm="slaney",
                             mel_scale="slaney").astype(np.float32)
    out, moved = _counted(lambda: fn(audio, fb=fb, **kw))
    assert symbols == [symbol] and moved == {name: 1}
    assert out.shape == (2, 101, 64) and out.dtype == torch.float32
    params = _c_parameters(KERNELS[name].source, symbol)
    cargs = symbols.cargs[symbol]
    assert [type(a) for a in cargs] == [kind for kind, _ in params]
    got = {pname: a.value for (kind, pname), a in zip(params, cargs) if kind is ctypes.c_int}
    assert {k: got[k] for k in want} == want
    fb128 = mel.mel_filter_bank(513, 128, 50.0, 14000.0, 48000).astype(np.float32)
    out, moved = _counted(lambda: fn(audio, fb=fb128, **kw))
    assert symbols == [symbol, symbol] and moved == {name: 1}
    assert out.shape == (2, 101, 128)
    got = {pname: a.value for (kind, pname), a in zip(params, symbols.cargs[symbol])
           if kind is ctypes.c_int}
    assert got["n_mels"] == 128 and got["n_keep"] == 384
