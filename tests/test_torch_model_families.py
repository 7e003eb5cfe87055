"""The port's other model families against the JAX package's on the CPU, at
``tiny_test()`` sizes with the reference's weights (each ``init_params``
draws the reference's numpy order) and numpy-drawn inputs:

* ``Bert``: ``pooled``, ``qa_spans`` and ``mean_embedding`` in f32 and
  dynamic int8 (``quantize_weights(params, "int8")``: M > 64 rows take
  per-tensor activation quantization and the int8 product, M <= 64 the
  bf16 dot), and invariance to what right padding holds;
* ``ViT`` (``patchify``, ``encode``, ``classify``) and ``DepthEstimator``;
  the bilinear upsample against ``jax.image.resize``, edges included;
* ``SAM`` and ``fourier_point_embedding``; the non-flipped transposed conv
  (``conv_lhs_dilated``) against ``conv_general_dilated`` with
  ``lhs_dilation`` at asymmetric kernels;
* ``Segmenter`` on the port's ResNet;
* ``TextToSpeech`` stage by stage;
* checkpoints (``save_params`` / ``load_params``) both ways with the
  JAX package, float and ``QuantWeight`` records, bit for bit;
* ``ctc`` (a copy) on ``Bert.encode_embeddings`` outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu import ctc as jctc
from rten_tpu.models import bert as jb
from rten_tpu.models import checkpoint as jck
from rten_tpu.models import sam as js
from rten_tpu.models import segmentation as jsg
from rten_tpu.models import transformer as jtr
from rten_tpu.models import tts as jt
from rten_tpu.models import vit as jv
from rten_tpu_torch import ctc as pctc
from rten_tpu_torch.models import bert as pb
from rten_tpu_torch.models import checkpoint as pck
from rten_tpu_torch.models import sam as ps
from rten_tpu_torch.models import segmentation as psg
from rten_tpu_torch.models import transformer as ptr
from rten_tpu_torch.models import tts as pt
from rten_tpu_torch.models import vit as pv

# f32 arithmetic in other orders on outputs of order 1 (LayerNorm-scaled
# hidden states, logits): 1e-5 of max |out|, at least 1e-5.
REL_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=REL_TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _same_leaves(got, want):
    """Port tree (tensors) against a reference tree, bit for bit."""
    a, b = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())


# -- BERT ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def bert():
    jm = jb.Bert(jb.BertConfig.tiny_test())
    pm = pb.Bert(pb.BertConfig.tiny_test())
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jp, pm, pm.init_params(0, device="cpu")


def _bert_inputs(b, s, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 100, (b, s))
    mask = np.ones((b, s), np.int32)
    for i in range(1, b, 2):              # right padding on odd rows
        mask[i, s // 2 + i:] = 0
    types = (np.arange(s)[None] >= s // 3).astype(np.int32).repeat(b, 0)
    return ids, mask, types


def test_bert_init_params_are_the_reference_weights(bert):
    _, jp, _, pp = bert
    _same_leaves(pp, jp)


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("b,s", [(2, 16), (4, 24)], ids=["M32", "M96"])
def test_bert_heads_match_reference(bert, kind, b, s):
    """The three heads at 32 token rows (the int8 weights as a bf16 dot)
    and 96 (per-tensor int8 activations, int8 product); the int8 trees
    are each package's own ``quantize_weights`` of the same weights."""
    jm, jp, pm, pp = bert
    if kind == "int8":
        jp, pp = (jtr.quantize_weights(jp, "int8"),
                  ptr.quantize_weights(pp, "int8"))
        assert isinstance(pp["layers"][0]["wq"], ptr.QuantWeight)
    ids, mask, types = _bert_inputs(b, s)
    jargs = (jnp.asarray(ids), jnp.asarray(mask))
    pargs = (_t(ids), _t(mask))
    _close(pm.pooled(pp, *pargs), jm.pooled(jp, *jargs))
    for got, want in zip(pm.qa_spans(pp, *pargs, token_type_ids=_t(types)),
                         jm.qa_spans(jp, *jargs,
                                     token_type_ids=jnp.asarray(types))):
        _close(got, want)
    _close(pm.mean_embedding(pp, *pargs), jm.mean_embedding(jp, *jargs))
    _close(pm.mean_embedding(pp, _t(ids)), jm.mean_embedding(jp,
                                                             jargs[0]))


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_bert_ignores_what_the_padding_holds(bert, kind):
    """Other token ids past each row's length change nothing before it
    (int8: M 96 rows; the per-tensor activation scale is the absmax of
    every row, padding included, so only f32 is held exactly there and
    int8 within 2e-2)."""
    _, _, pm, pp = bert
    if kind == "int8":
        pp = ptr.quantize_weights(pp, "int8")
    ids, mask, _ = _bert_inputs(4, 24, seed=1)
    other = np.where(mask == 1, ids, 7)
    a = pm.forward(pp, _t(ids), _t(mask))
    b = pm.forward(pp, _t(other), _t(mask))
    live = torch.from_numpy(mask.astype(bool))
    err = (a - b)[live].abs().max().item()
    assert err <= (1e-6 if kind == "f32" else 2e-2), err


def test_ctc_copy_matches_reference_on_bert_frames(bert):
    """The wav2vec2-CTC pairing: acoustic frames through
    ``encode_embeddings``, a linear head, then greedy and beam CTC decoding
    in both packages on the same log-probabilities."""
    jm, jp, pm, pp = bert
    frames = np.random.default_rng(4).standard_normal(
        (1, 20, 64)).astype(np.float32)
    hidden = pm.encode_embeddings(pp, _t(frames))
    _close(hidden, jm.encode_embeddings(jp, jnp.asarray(frames)))
    head = np.random.default_rng(5).standard_normal((64, 5)).astype(
        np.float32)
    logits = hidden[0].numpy() @ head
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    greedy = pctc.ctc_greedy_decode(logp)
    assert greedy.steps == jctc.ctc_greedy_decode(logp).steps
    assert greedy.labels()
    got = pctc.ctc_beam_search_decode(logp, beam_size=3)
    want = jctc.ctc_beam_search_decode(logp, beam_size=3)
    assert [(h.steps, h.score) for h in got] == \
        [(h.steps, h.score) for h in want]


# -- ViT and depth ------------------------------------------------------------

IMAGES = np.random.default_rng(5).standard_normal(
    (2, 3, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("cls", [True, False], ids=["cls", "mean"])
def test_vit_matches_reference(cls):
    jm = jv.ViT(jv.ViTConfig.tiny_test(use_cls_token=cls))
    pm = pv.ViT(pv.ViTConfig.tiny_test(use_cls_token=cls))
    jp, pp = jm.init_params(None), pm.init_params(0, device="cpu")
    _same_leaves(pp, jp)
    assert torch.equal(pm.patchify(_t(IMAGES)),
                       _t(jm.patchify(jnp.asarray(IMAGES))))
    _close(pm.encode(pp, _t(IMAGES)), jm.encode(jp, jnp.asarray(IMAGES)))
    _close(pm.classify(pp, _t(IMAGES)), jm.classify(jp,
                                                    jnp.asarray(IMAGES)))


def test_depth_estimator_matches_reference():
    jm = jv.DepthEstimator(jv.DepthConfig.tiny_test())
    pm = pv.DepthEstimator(pv.DepthConfig.tiny_test())
    jp, pp = jm.init_params(None), pm.init_params(0, device="cpu")
    _same_leaves(pp, jp)
    got = pm.predict(pp, _t(IMAGES))
    assert got.shape == (2, 32, 32)
    _close(got, jm.predict(jp, jnp.asarray(IMAGES)))


@pytest.mark.parametrize("src,dst", [((4, 4), (32, 32)), ((3, 5), (7, 16)),
                                     ((14, 14), (224, 224)),
                                     ((2, 1), (9, 4))], ids=str)
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    """Half-pixel centres; the first and last rows and columns take the
    edge samples (the reference renormalises the weights it covers)."""
    x = np.random.default_rng(6).standard_normal((2, 3, *src)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3, *dst), method="bilinear")
    _close(pv.resize_bilinear(_t(x), dst), want, rel=1e-6)


# -- SAM ----------------------------------------------------------------------

def test_fourier_point_embedding_matches_reference():
    pts = np.random.default_rng(7).random((3, 4, 2)).astype(np.float32)
    for d, n_freqs in ((64, None), (48, 8), (40, 12)):
        _close(ps.fourier_point_embedding(_t(pts), d, n_freqs),
               js.fourier_point_embedding(jnp.asarray(pts), d, n_freqs),
               rel=1e-5)


@pytest.mark.parametrize("k,stride,pads", [
    ((3,), 2, [(1, 2)]), ((4,), 3, [(2, 3)]), ((2, 3), 2, [(0, 1), (1, 1)]),
    ((3, 2), 2, [(0, 1), (0, 1)])], ids=str)
def test_conv_lhs_dilated_is_not_flipped(k, stride, pads):
    """The reference's transposed convs: correlation over the zero-stuffed
    input with the kernel as it is, at asymmetric kernels (a flip would
    change every output); the kernel flipped misses."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, *(5,) * len(k))).astype(np.float32)
    w = rng.standard_normal((3, 4, *k)).astype(np.float32)     # [I, O, ...]
    spec = "NCH" if len(k) == 1 else "NCHW"
    dn = (spec, "IO" + spec[2:], spec)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1,) * len(k), pads,
        lhs_dilation=(stride,) * len(k), dimension_numbers=dn)
    got = ps.conv_lhs_dilated(_t(x), _t(w), stride, pads)
    _close(got, want)
    flipped = ps.conv_lhs_dilated(_t(x), _t(w).flip(
        tuple(range(2, 2 + len(k)))), stride, pads)
    assert np.abs(flipped.numpy() - np.asarray(want)).max() > 1e-2


@pytest.fixture(scope="module")
def sam():
    jm, pm = js.SAM(js.SAMConfig.tiny_test()), ps.SAM(ps.SAMConfig.tiny_test())
    return jm, jm.init_params(None), pm, pm.init_params(0, device="cpu")


def test_sam_matches_reference_stage_by_stage(sam):
    """The image encoder, then the masks and IoU of two prompts (3 and 1
    valid points of 4)."""
    jm, jp, pm, pp = sam
    _same_leaves(pp, jp)
    _close(pm.encoder.encode(pp["encoder"], _t(IMAGES)),
           jm.encoder.encode(jp["encoder"], jnp.asarray(IMAGES)))
    rng = np.random.default_rng(9)
    pts = rng.random((2, 4, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (2, 4)).astype(np.int32)
    n = np.array([3, 1], np.int32)
    want = jm.predict(jp, jnp.asarray(IMAGES), jnp.asarray(pts),
                      jnp.asarray(labels), jnp.asarray(n))
    got = pm.predict(pp, _t(IMAGES), _t(pts), _t(labels), _t(n))
    assert got[0].shape == (2, 32, 32) and got[1].shape == (2,)
    _close(got[0], want[0])
    _close(got[1], want[1])


# -- segmentation -------------------------------------------------------------

def test_segmenter_matches_reference():
    """The ResNet-18 backbone and the ASPP head at 64 x 64 (a 2 x 2 map
    upsampled 32 x): logits within 1e-5 of max |logit|, class ids equal
    where the top two logits are more than 1e-3 apart."""
    jm = jsg.Segmenter(jsg.SegmentationConfig.tiny_test())
    pm = psg.Segmenter(psg.SegmentationConfig.tiny_test())
    jp, pp = jm.init_params(None), pm.init_params(0, device="cpu")
    _same_leaves(pp, jp)
    x = np.random.default_rng(10).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    want = np.asarray(jm.forward(jp, jnp.asarray(x)))
    got = pm.forward(pp, _t(x))
    _close(got, want)
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-3
    ids = pm.predict(pp, _t(x)).numpy()
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids[clear], np.asarray(
        jm.predict(jp, jnp.asarray(x)))[clear])


# -- TTS ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tts():
    jm = jt.TextToSpeech(jt.TTSConfig.tiny_test())
    pm = pt.TextToSpeech(pt.TTSConfig.tiny_test())
    rng = np.random.default_rng(11)
    phonemes = rng.integers(0, 32, (3, 16)).astype(np.int32)
    lengths = np.array([16, 9, 3], np.int32)
    return (jm, jm.init_params(None), pm, pm.init_params(0, device="cpu"),
            phonemes, lengths)


def test_tts_matches_reference_stage_by_stage(tts):
    """``durations`` = round(exp(clip(log_dur)) * pace) is a step function
    of the encoder's output, so the durations are compared first (equal
    here), then each later stage at the reference's durations: frames and
    masks, mel, waveform; then the whole ``synthesize``."""
    jm, jp, pm, pp, ph, ln = tts
    _same_leaves(pp, jp)
    jh = jm.encode(jp, jnp.asarray(ph), jnp.asarray(ln))
    ph_t, ln_t = _t(ph), _t(ln)
    _close(pm.encode(pp, ph_t, ln_t), jh)
    log_dur = (jh @ jp["dur_w"] + jp["dur_b"])[..., 0]
    jdur = jnp.maximum(jnp.round(jnp.exp(jnp.clip(log_dur, -3, 3)))
                       .astype(jnp.int32), 1)
    pdur = pm.durations(pp, pm.encode(pp, ph_t, ln_t))
    np.testing.assert_array_equal(pdur.numpy(), np.asarray(jdur))
    jf, jmask, jn = jm.length_regulate(jh, jdur, jnp.asarray(ln))
    pf, pmask, pn = pm.length_regulate(_t(jh), _t(jdur), ln_t)
    assert torch.equal(pf, _t(jf)) and torch.equal(pmask, _t(jmask))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    jmel = jm.mel(jp, jf, jmask)
    _close(pm.mel(pp, _t(jf), _t(jmask)), jmel)
    _close(pm.vocode(pp, _t(jmel)), jm.vocode(jp, jmel))
    jwave, jsamples = jm.synthesize(jp, jnp.asarray(ph), jnp.asarray(ln))
    pwave, psamples = pm.synthesize(pp, ph_t, ln_t)
    assert pwave.shape == (3, 32 * 16)
    np.testing.assert_array_equal(psamples.numpy(), np.asarray(jsamples))
    _close(pwave, jwave)


# -- checkpoints --------------------------------------------------------------

def _tree_pair(kind):
    """A TransformerLM tree in both packages: f32, int8 (per-channel
    records, N 192 and the tied head's 128; the port pads nothing here)
    or int4 (word-packed records)."""
    cfg = dict(vocab_size=100, d_model=64, n_heads=4, d_ff=96)
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**cfg))
    pm = ptr.TransformerLM(ptr.TransformerConfig.tiny_test(**cfg))
    jp = jm.init_params(jax.random.PRNGKey(3))
    pp = pm.init_params(3, device="cpu")
    if kind != "f32":
        jp = jtr.quantize_weights(jp, kind)
        pp = ptr.quantize_weights(pp, kind)
    return jp, pp


def _flat_npz(path):
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
def test_checkpoint_files_interchange_with_reference(kind, tmp_path):
    """The port's file holds the reference's keys and arrays bit for bit
    (``#q{kind,group,n}`` records unpadded), the JAX package loads it, and
    the port loads the reference's file to its own tree."""
    jp, pp = _tree_pair(kind)
    jck.save_params(tmp_path / "ref.npz", jp)
    pck.save_params(tmp_path / "port.npz", pp)
    ref, port = _flat_npz(tmp_path / "ref.npz"), _flat_npz(
        tmp_path / "port.npz")
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key].dtype == ref[key].dtype, key
        assert np.array_equal(port[key], ref[key]), key
    back = jck.load_params(tmp_path / "port.npz")
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    loaded = pck.load_params(tmp_path / "ref.npz", device="cpu")
    _assert_same_port_tree(loaded, pp)


def _assert_same_port_tree(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same_port_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same_port_tree(a, b)
    elif isinstance(want, ptr.QuantWeight):
        assert (got.kind, got.n, got.group) == (want.kind, want.n,
                                                want.group)
        assert torch.equal(got.data, want.data)
        assert torch.equal(got.scales, want.scales)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_checkpoint_padded_int8_round_trip(tmp_path):
    """An int8 weight of N 2 (BERT's QA head), padded to 8 columns in the
    port: the file holds the 2 reference columns and loads back padded,
    equal to the port's own quantization, in both packages; the
    quantized BERT heads run from the loaded tree."""
    jm, pm = jb.Bert(jb.BertConfig.tiny_test()), pb.Bert(
        pb.BertConfig.tiny_test())
    jp = jtr.quantize_weights(jm.init_params(None), "int8")
    pp = ptr.quantize_weights(pm.init_params(0, device="cpu"), "int8")
    assert pp["qa_w"].data.shape == (64, 8) and pp["qa_w"].n == 2
    pck.save_params(tmp_path / "bert.npz", pp)
    flat = _flat_npz(tmp_path / "bert.npz")
    assert flat["qa_w#q{int8,128,2}/data"].shape == (64, 2)
    back = jck.load_params(tmp_path / "bert.npz")
    assert np.array_equal(np.asarray(back["qa_w"].data),
                          np.asarray(jp["qa_w"].data))
    loaded = pck.load_params(tmp_path / "bert.npz", device="cpu")
    _assert_same_port_tree(loaded, pp)
    ids, mask, _ = _bert_inputs(4, 24)
    for got, want in zip(pm.qa_spans(loaded, _t(ids), _t(mask)),
                         jm.qa_spans(back, jnp.asarray(ids),
                                     jnp.asarray(mask))):
        _close(got, want)


def test_entry_points_default_to_the_card(tmp_path):
    """Every family's ``init_params``, the encoder-decoder's ``new_cache``
    and ``load_params`` default to CUDA and raise without a card instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less "
                    "behaviour")
    from rten_tpu_torch.models import encoder_decoder as ped
    ed = ped.EncoderDecoderLM(ped.EncoderDecoderConfig.tiny_test())
    pck.save_params(tmp_path / "p.npz", {"w": torch.zeros(2)})
    for call in (
            ed.init_params, lambda: ed.new_cache(2),
            pb.Bert(pb.BertConfig.tiny_test()).init_params,
            pv.ViT(pv.ViTConfig.tiny_test()).init_params,
            pv.DepthEstimator(pv.DepthConfig.tiny_test()).init_params,
            ps.SAM(ps.SAMConfig.tiny_test()).init_params,
            psg.Segmenter(psg.SegmentationConfig.tiny_test()).init_params,
            pt.TextToSpeech(pt.TTSConfig.tiny_test()).init_params,
            lambda: pck.load_params(tmp_path / "p.npz")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
