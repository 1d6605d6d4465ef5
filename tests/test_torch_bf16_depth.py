"""bf16 at two layers: the port against the reference's fp32 logits.

At one layer the port's bf16 logits stay within the 2e-2 band of the
reference's bf16 logits (``tests/test_torch_dense_configs.py``,
``tests/test_torch_moe.py``).  At two layers they do not always, and the
reason is not the port: XLA picks where bf16 values are rounded (the
reference with ``--xla_allow_excess_precision`` on and off parts from
itself at two layers by about as much as the port parts from it), so two
faithful bf16 runs of one model differ by about as much as either differs
from exact arithmetic.

What is held here is the meaningful quantity: from the same bf16-valued
params, the reference in fp32 gives the logits bf16 approximates.  The
port's bf16 gap to them, max |port - fp32| / max |fp32| over prefill and
four greedy decode steps, must be at most ``MULTIPLE`` times the
reference's own bf16 gap to the same fp32 logits.  Over the eight configs
and seeds 0-5 the ratio measured 0.77-1.45 (the gaps themselves 2-158%, the
smoke inits' residual stream of ~900 amplifying bf16 rounding), so 1.5
leaves room for a seed's spread while a port that rounded worse than the
reference by half again would fail.  jamba runs one group of its 8-layer
pattern, its smallest stack, and llama-3.2-vision-90b one group of its
5-layer pattern, with image embeddings from the seed (bf16, as the model's
activations) and its zero-initialised ``attn_gate``/``ffn_gate`` drawn in
[0.5, 1.5], so that the cross-attention branches add something."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

ARCHS = ("qwen2.5-3b", "internlm2-1.8b", "yi-9b", "gemma-7b", "mixtral-8x7b",
         "moonshot-v1-16b-a3b", "mamba2-2.7b", "jamba-1.5-large-398b",
         "musicgen-large", "llama-3.2-vision-90b")
MULTIPLE = 1.5
STEPS = 4


def _reference_logits(jc, params, dtype, toks, lens, feed, image):
    """Prefill + decode logits of the reference in ``dtype``; the decode
    steps take the tokens ``feed`` gives (the fp32 run's argmax).
    ``image``: the image embeddings of a cross-attention model, or
    None."""
    cache = JM.init_cache(jc, 3, 64, dtype)
    kw = {} if image is None else {"cross_kv": jnp.asarray(image, dtype)}
    logits, cache = jax.jit(lambda p, c, t, l, kw: JM.prefill(
        jc, p, t, cache=c, prompt_lens=l, **kw))(
            params, cache, jnp.asarray(toks), jnp.asarray(lens), kw)
    out = [np.asarray(logits, np.float32)]
    step = jax.jit(lambda p, c, t, l: JM.decode_step(jc, p, c, t, l))
    kv = lens.copy()
    for i in range(STEPS):
        tok = feed(i, out[-1])
        logits, cache = step(params, cache, jnp.asarray(tok), jnp.asarray(kv))
        out.append(np.asarray(logits, np.float32))
        kv = kv + 1
    return np.stack(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_layer_bf16_gap_to_fp32_within_the_reference_gap(arch, seed):
    # two layers; jamba's smallest stack is one group of its 8-layer pattern
    layers = max(2, len(jax_get_smoke(arch).group_pattern))
    kw = dict(num_layers=layers, decode_cache_update="scatter")
    jb = dataclasses.replace(jax_get_smoke(arch), dtype="bfloat16", **kw)
    jf = dataclasses.replace(jax_get_smoke(arch), **kw)
    tb = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16", **kw)
    pb = jax_init_params(JM.param_specs(jb), jax.random.PRNGKey(seed),
                         jnp.bfloat16)
    rng = np.random.default_rng(seed)
    if jb.vision_seq:
        pb = jax.tree_util.tree_map_with_path(
            lambda path, leaf: jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape),
                                           leaf.dtype)
            if jax.tree_util.keystr(path).endswith("gate']") else leaf, pb)
    pf = jax.tree.map(lambda a: a.astype(jnp.float32), pb)
    toks = rng.integers(0, jb.vocab_size, (3, 16)).astype(np.int32)
    lens = np.array([16, 5, 9], np.int32)
    # bf16-valued image embeddings, so both runs see the same values
    image = (np.asarray(jnp.asarray(rng.standard_normal(
        (3, jb.vision_seq, jb.d_model), np.float32), jnp.bfloat16),
        np.float32) if jb.vision_seq else None)

    fed = []          # every run decodes the fp32 reference's greedy tokens

    def feed_fp32(i, last):
        fed.append(np.argmax(last, -1).astype(np.int32))
        return fed[i]

    ref32 = _reference_logits(jf, pf, jnp.float32, toks, lens, feed_fp32,
                              image)
    ref16 = _reference_logits(jb, pb, jnp.bfloat16, toks, lens,
                              lambda i, _: fed[i], image)
    tp = params_from_numpy(pb, device="cpu")
    cache = TM.init_cache(tb, 3, 64, torch.bfloat16, device="cpu")
    kw = ({} if image is None else
          {"cross_kv": torch.from_numpy(image).bfloat16()})
    logits, cache = TM.prefill(tb, tp, torch.from_numpy(toks), cache=cache,
                               prompt_lens=torch.from_numpy(lens), **kw)
    port = [logits.float().numpy()]
    kv = lens.copy()
    for i in range(STEPS):
        logits, cache = TM.decode_step(tb, tp, cache, torch.from_numpy(fed[i]),
                                       torch.from_numpy(kv))
        port.append(logits.float().numpy())
        kv = kv + 1
    port = np.stack(port)
    assert np.all(np.isfinite(port))
    scale = np.abs(ref32).max()
    ref_gap = np.abs(ref16 - ref32).max() / scale
    port_gap = np.abs(port - ref32).max() / scale
    assert ref_gap > 0
    assert port_gap <= MULTIPLE * ref_gap, (
        f"{arch} seed {seed}: the port's bf16 gap to the fp32 logits is "
        f"{port_gap:.4f}, the reference's {ref_gap:.4f}")
