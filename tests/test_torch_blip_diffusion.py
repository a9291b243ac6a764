"""BLIP-Diffusion in the port (models/blip_diffusion.py, the zoo's
blip_diffusion) against the JAX package's, on the CPU, at the tiny
config, from the same numpy tree (the port's own init, carried into both)
and seeded inputs.

The UNet is the caller's callable in both packages: here a linear
stand-in written in each framework (the latents scaled, plus the
prompt embedding's mean through a fixed matrix, plus the timestep), so
the loss reaches every tower. JAX references: two compiled
programs (tests/lavis_ref.run_all): train_loss with its gradient on every
leaf but the subject ViT's (jax.value_and_grad; the noise and timesteps it
draws from its key are returned and handed to the port's keywords), and
generate with 4 DDIM
steps and classifier-free guidance (its initial latents likewise) beside
ctx_embeddings, encode_prompt_ctx with and without the ctx, add_noise and
two ddim_steps (one the final step, which uses ᾱ[0]). Tolerances: embeddings within
1e-5, the loss within 1e-6, gradients and the generated latents within
1e-5 of their largest; add_noise, ddim_step and the timesteps equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import close, grads_close, np_tree, one_torch_thread, port_grads, run_all  # noqa: F401 (a fixture)
from llava_align_tpu.models import blip_diffusion as jd
from llava_align_tpu_torch.models import blip_diffusion as td
from llava_align_tpu_torch.utils.jax_params import from_jax_params

B, S, T_SUBJ, STEPS = 2, 8, 5, 4
LATENT = (B, 4, 8, 8)


def trained(tree):
    """The tree but the subject's ViT: what the gradients are held on (the
    reference fine-tunes the text side; the ViT's backward adds nothing the
    other LAVIS tests do not hold)."""
    return {k: v for k, v in tree.items() if k != "visual"}


def unets(W: np.ndarray):
    """The linear stand-in UNet, (JAX, torch)."""
    def jax_unet(x, t, cond):
        ctx = jnp.einsum("bsd,dc->bc", cond, jnp.asarray(W)) / cond.shape[1]
        return 0.2 * x + ctx[:, :, None, None] + 1e-3 * t.astype(jnp.float32)[:, None, None, None]

    Wt = torch.from_numpy(W)

    def torch_unet(x, t, cond):
        ctx = torch.einsum("bsd,dc->bc", cond, Wt.to(cond.device)) / cond.shape[1]
        return 0.2 * x + ctx[:, :, None, None] + 1e-3 * t.float()[:, None, None, None]

    return jax_unet, torch_unet


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def ref():
    cfg, tcfg = jd.BlipDiffusionConfig.tiny(), td.BlipDiffusionConfig.tiny()
    tree = np_tree(td.init(tcfg, device="cpu", seed=5))
    rng = np.random.default_rng(2)
    size, D = cfg.vision.image_size, cfg.text.text.width
    data = {
        "pix": rng.standard_normal((B, 3, size, size)).astype(np.float32),
        "subj_ids": rng.integers(3, 120, (B, T_SUBJ)).astype(np.int32),
        "subj_mask": np.ones((B, T_SUBJ), np.int32),
        "prompt": rng.integers(1, 64, (B, S)).astype(np.int32),
        "neg": rng.integers(1, 64, (B, S)).astype(np.int32),
        "latents": rng.standard_normal(LATENT).astype(np.float32),
        "eps": rng.standard_normal(LATENT).astype(np.float32),
        "t": np.array([3, 41], np.int32),
        "W": (rng.standard_normal((D, 4)) / D**0.5).astype(np.float32),
    }
    data["subj_mask"][1, 3:] = 0
    J = {k: jnp.asarray(v) for k, v in data.items()}
    jax_unet, _ = unets(data["W"])
    subject = (J["pix"], J["subj_ids"], J["subj_mask"])

    def forwards(p):
        ctx = jd.ctx_embeddings(p, cfg, *subject)
        return {"ctx": ctx, "cond": jd.encode_prompt_ctx(p, cfg, J["prompt"], ctx),
                "uncond": jd.encode_prompt_ctx(p, cfg, J["neg"]),
                "noisy": jd.add_noise(cfg, J["latents"], J["eps"], J["t"]),
                "step": jd.ddim_step(cfg, J["latents"], J["eps"], 37, 25),
                "last": jd.ddim_step(cfg, J["latents"], J["eps"], 1, -1)}

    def generate_and_forwards(p, key):  # one program: XLA shares the towers' work
        return generate(p, key), forwards(p)

    def loss(p, key):
        k1, k2 = jax.random.split(key)
        draws = {"noise": jax.random.normal(k1, LATENT, jnp.float32),
                 "timesteps": jax.random.randint(k2, (B,), 0, cfg.scheduler.num_train_timesteps)}
        value, grads = jax.value_and_grad(lambda q: jd.train_loss(
            {**q, "visual": p["visual"]}, cfg, key, J["latents"], J["prompt"], *subject, jax_unet))(trained(p))
        return value, grads, draws

    def generate(p, key):
        out = jd.generate(p, cfg, key, J["prompt"][:1], J["neg"][:1], J["pix"][:1], J["subj_ids"][:1],
                          J["subj_mask"][:1], jax_unet, latent_shape=(1,) + LATENT[1:], num_inference_steps=STEPS)
        return out, jax.random.normal(key, (1,) + LATENT[1:], jnp.float32)

    want = run_all({"loss": (loss, tree, jax.random.PRNGKey(8)),
                    "generate": (generate_and_forwards, tree, jax.random.PRNGKey(9))})
    want["generate"], want["forwards"] = want["generate"]
    return want, tree, {k: torch.from_numpy(v) for k, v in data.items()}


def test_embeddings_match_jax(ref):
    want, tree, d = ref
    cfg, p = td.BlipDiffusionConfig.tiny(), from_jax_params(tree, device="cpu")
    ctx = td.ctx_embeddings(p, cfg, d["pix"], d["subj_ids"], d["subj_mask"])
    close(ctx, want["forwards"]["ctx"], "ctx_embeddings")
    cond = td.encode_prompt_ctx(p, cfg, d["prompt"], ctx)
    assert cond.shape == (B, S + cfg.qformer.query_length, cfg.text.text.width)
    close(cond, want["forwards"]["cond"], "encode_prompt_ctx with ctx")
    close(td.encode_prompt_ctx(p, cfg, d["neg"]), want["forwards"]["uncond"], "encode_prompt_ctx without ctx")


def test_schedule_noise_and_ddim_step_equal_jax(ref):
    want, _, d = ref
    cfg = td.BlipDiffusionConfig.tiny()
    for c in (cfg, td.BlipDiffusionConfig()):
        jc = jd.BlipDiffusionConfig.tiny() if c is cfg else jd.BlipDiffusionConfig()
        np.testing.assert_array_equal(c.scheduler.alphas_cumprod(), jc.scheduler.alphas_cumprod())
        for n in (4, 50):
            np.testing.assert_array_equal(td.ddim_timesteps(c, n), jd.ddim_timesteps(jc, n))
    assert td.ddim_timesteps(td.BlipDiffusionConfig(), 50)[[0, -1]].tolist() == [981, 1]
    np.testing.assert_array_equal(td.add_noise(cfg, d["latents"], d["eps"], d["t"]).numpy(),
                                  want["forwards"]["noisy"])
    np.testing.assert_array_equal(td.ddim_step(cfg, d["latents"], d["eps"], 37, 25).numpy(),
                                  want["forwards"]["step"])
    np.testing.assert_array_equal(td.ddim_step(cfg, d["latents"], d["eps"], 1, -1).numpy(),
                                  want["forwards"]["last"])


def test_train_loss_and_gradients_match_jax(ref):
    want, tree, d = ref
    cfg = td.BlipDiffusionConfig.tiny()
    value, grads, draws = want["loss"]
    _, unet = unets(d["W"].numpy())
    p = from_jax_params(tree, device="cpu")
    loss, got = port_grads(lambda q: td.train_loss(
        {**q, "visual": p["visual"]}, cfg, None, d["latents"], d["prompt"], d["pix"], d["subj_ids"], d["subj_mask"],
        unet, noise=torch.from_numpy(np.asarray(draws["noise"])),
        timesteps=torch.from_numpy(np.asarray(draws["timesteps"]))), trained(p))
    close(loss, value, "train_loss", atol=1e-6)
    grads_close(got, grads, "train_loss")
    # the draws from a generator instead: a finite loss, timesteps in range
    drawn = td.train_loss(from_jax_params(tree, device="cpu"), cfg, torch.Generator().manual_seed(0), d["latents"],
                          d["prompt"], d["pix"], d["subj_ids"], d["subj_mask"], unet)
    assert torch.isfinite(drawn)


def test_generate_matches_jax(ref):
    want, tree, d = ref
    cfg = td.BlipDiffusionConfig.tiny()
    out, latents = want["generate"]
    _, unet = unets(d["W"].numpy())
    got = td.generate(from_jax_params(tree, device="cpu"), cfg, None, d["prompt"][:1], d["neg"][:1], d["pix"][:1],
                      d["subj_ids"][:1], d["subj_mask"][:1], unet, latent_shape=(1,) + LATENT[1:],
                      num_inference_steps=STEPS, latents=torch.from_numpy(np.asarray(latents)))
    # the unscaled latents reach ~30 (CFG's 7.5x, then / 0.18215): held
    # within 1e-5 of their largest, as the gradients are
    scale = float(np.abs(out).max())
    close(got / scale, out / scale, "generate (4 DDIM steps, CFG 7.5)")
    images = td.generate(from_jax_params(tree, device="cpu"), cfg, torch.Generator().manual_seed(1),
                         d["prompt"][:1], d["neg"][:1], d["pix"][:1], d["subj_ids"][:1], d["subj_mask"][:1], unet,
                         latent_shape=(1,) + LATENT[1:], num_inference_steps=2, vae_decode=lambda x: x.tanh())
    assert images.shape == (1,) + LATENT[1:] and images.abs().max() <= 1


def test_build_prompt_copy():
    args = (["on the beach ", "in snow"], ["dog", "cat"])
    for kw in ({}, {"prompt_strength": 0.5, "prompt_reps": 4}):
        assert td.build_prompt(*args, **kw) == jd.build_prompt(*args, **kw)
    assert td.build_prompt(["x"], ["dog"], prompt_reps=2) == ["a dog x, a dog x"]
