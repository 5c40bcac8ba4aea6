"""Hold the PyTorch port against the JAX package on a staged SAM-Audio
checkpoint, stage by stage, in fp32 on the CPU.

    python scripts/validate_torch_checkpoint.py --snapshot DIR [--t5 t5.pt] [--tol 1e-4]

DIR holds the reference's config.json and checkpoint.pt. Both packages load
it through their own converters (`sam_audio_tpu.checkpoint.load_sam_audio`
and `sam_audio_tpu_torch.checkpoint.load_sam_audio`, compute_dtype forced to
float32), and the same inputs, made from `--seed`, go through both:

  A. the velocity field: one DiT evaluation with text, video and anchor
     conditioning (`forward`);
  B. the 32-evaluation midpoint ODE from shared noise;
  C. the codec's encode of a seeded waveform;
  D. the codec's decode of seeded latents, to a waveform;
  E. the full `separate()` at k=2 (no ranker: candidate 0) with an anchor
     and shared noise, target and residual.

checkpoint.pt holds no text tower (reference model.py:346-359): with `--t5`
(an HF T5 encoder state dict) both packages convert it; without it the JAX
package's random tower is copied into the port, so that the text features
agree. Both tokenize with their byte-level fallback (the same ids): the
stages hold the port's weights and pipeline against JAX's, not a tokenizer.
Rankers and the span predictor are left out.

One line a stage with its max |port - JAX|; exit 0 only if every stage is
within `--tol`. The hermetic test (tests/test_torch_validate_checkpoint.py)
runs it on a reference-shaped checkpoint built from the test oracles, and
on a perturbed port load, which must fail stage A.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

STAGES = ("A velocity field", "B ODE, 32 evaluations", "C codec encode", "D codec decode",
          "E separate, k=2")


def load_both(snapshot: str, t5: Optional[str] = None):
    """(the JAX package's SAMAudio, the port's SAMAudio), fp32, on the CPU."""
    from sam_audio_tpu.checkpoint import load_sam_audio as jax_load
    from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JaxBytes
    from sam_audio_tpu_torch import checkpoint as port_checkpoint
    from sam_audio_tpu_torch.checkpoint import params_from_numpy
    from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

    jm = jax_load(snapshot, t5_path=t5, allow_random_towers=True, compute_dtype="float32")
    vocab = jm.cfg.text_encoder.vocab_size
    jm._tokenizer = JaxBytes(vocab)
    pm = port_checkpoint.load_sam_audio(snapshot, device="cpu", allow_random_towers=True,
                                        t5_path=t5, tokenizer=ByteFallbackTokenizer(vocab),
                                        compute_dtype="float32")
    if t5 is None:
        import jax

        pm.params["text_encoder"] = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jm.params["text_encoder"]))
    for m in (jm, pm):
        m.text_ranker = m.visual_ranker = m.span_predictor = None
    return jm, pm


def run_stages(jm, pm, seed: int = 0, t_frames: int = 12, text_len: int = 5):
    """{stage: max |port - JAX|} on inputs made from `seed`."""
    import jax.numpy as jnp
    import torch

    from sam_audio_tpu.models import dacvae as jax_dacvae
    from sam_audio_tpu.models.sam_audio import forward as jax_forward
    from sam_audio_tpu.ops.ode import odeint as jax_odeint
    from sam_audio_tpu.processor import SAMAudioProcessor as JaxProcessor
    from sam_audio_tpu_torch import SAMAudioProcessor
    from sam_audio_tpu_torch.models import dacvae
    from sam_audio_tpu_torch.models.sam_audio import forward
    from sam_audio_tpu_torch.ops.ode import odeint

    cfg = pm.cfg
    rng = np.random.RandomState(seed)
    b, t, c2 = 1, t_frames, 2 * cfg.audio_codec.codebook_dim
    cond = dict(
        audio_features=rng.randn(b, t, c2).astype(np.float32),
        text_features=rng.randn(b, text_len, cfg.text_encoder.dim).astype(np.float32),
        masked_video_features=rng.randn(b, cfg.vision_encoder.dim, t).astype(np.float32),
        text_mask=np.ones((b, text_len), bool),
        anchor_ids=np.array([[0, 1, 2, 3]], np.int64),
        anchor_alignment=rng.randint(0, 3, size=(b, t)).astype(np.int64),
        audio_pad_mask=np.ones((b, t), bool))
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    f32 = torch.float32
    errs = {}

    def diff(port, ref):
        return float(np.abs(np.asarray(port, np.float64).reshape(-1)
                            - np.asarray(ref, np.float64).reshape(-1)).max())

    with torch.inference_mode():
        y = rng.randn(b, t, c2).astype(np.float32)
        time = rng.rand(b).astype(np.float32)
        errs[STAGES[0]] = diff(
            forward(pm.params, cfg, noisy_audio=torch.from_numpy(y),
                    time=torch.from_numpy(time), compute_dtype=f32, **tcond),
            jax_forward(jm.params, jm.cfg, noisy_audio=jnp.asarray(y), time=jnp.asarray(time),
                        compute_dtype=jnp.float32, **jcond))

        noise = rng.randn(b, t, c2).astype(np.float32)
        port_lat = odeint(lambda tt, yy: forward(pm.params, cfg, noisy_audio=yy,
                                                 time=tt.expand(b), compute_dtype=f32, **tcond),
                          torch.from_numpy(noise), method="midpoint", step_size=2 / 32)
        jax_lat = jax_odeint(lambda tt, yy: jax_forward(
            jm.params, jm.cfg, noisy_audio=yy, time=jnp.broadcast_to(tt, (b,)),
            compute_dtype=jnp.float32, **jcond), jnp.asarray(noise), method="midpoint",
            step_size=2 / 32)
        errs[STAGES[1]] = diff(port_lat, jax_lat)

        hop = cfg.audio_codec.hop_length
        wav = (0.1 * rng.randn(b, 1, hop * 16)).astype(np.float32)
        errs[STAGES[2]] = diff(
            dacvae.encode(pm.params["audio_codec"], torch.from_numpy(wav), cfg.audio_codec,
                          compute_dtype=f32),
            jax_dacvae.encode(jm.params["audio_codec"], jnp.asarray(wav), jm.cfg.audio_codec,
                              compute_dtype=jnp.float32))
        lat = rng.randn(b, cfg.audio_codec.codebook_dim, 16).astype(np.float32)
        errs[STAGES[3]] = diff(
            dacvae.decode(pm.params["audio_codec"], torch.from_numpy(lat), cfg.audio_codec,
                          compute_dtype=f32),
            jax_dacvae.decode(jm.params["audio_codec"], jnp.asarray(lat), jm.cfg.audio_codec,
                              compute_dtype=jnp.float32))

    sr = cfg.audio_codec.sample_rate
    mix = (0.1 * rng.randn(1, hop * 16)).astype(np.float32)
    kwargs = dict(descriptions=["a test tone"], audios=[mix],
                  anchors=[[("+", 0.0, 4.0 * hop / sr)]])
    k = 2
    e_noise = rng.randn(k, 16, c2).astype(np.float32)
    port = pm.separate(SAMAudioProcessor(hop, sr)(**kwargs), noise=e_noise,
                       reranking_candidates=k)
    ref = jm.separate(JaxProcessor(audio_hop_length=hop, audio_sampling_rate=sr)(**kwargs),
                      noise=jnp.asarray(e_noise), reranking_candidates=k)
    errs[STAGES[4]] = max(diff(a, r) for a, r in zip(port.target + port.residual,
                                                     list(ref.target) + list(ref.residual)))
    return errs


def main(snapshot: str, tol: float = 1e-4, seed: int = 0, t5: Optional[str] = None) -> int:
    jm, pm = load_both(snapshot, t5)
    errs = run_stages(jm, pm, seed)
    ok = True
    for stage in STAGES:
        passed = errs[stage] <= tol
        ok &= passed
        print(f"{stage:24s} max |port - jax| = {errs[stage]:.3e}  "
              f"{'PASS' if passed else 'FAIL'} (tol {tol:g})")
    print("VALIDATION " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snapshot", required=True, help="dir with config.json + checkpoint.pt")
    ap.add_argument("--t5", default=None, help="an HF T5 encoder state dict (.pt) for the "
                                              "text tower of both packages")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    raise SystemExit(main(args.snapshot, args.tol, args.seed, args.t5))
