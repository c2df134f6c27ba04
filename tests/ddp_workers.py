"""The ranks of the port's data-parallel CPU tests: functions that
``parallel.ddp.launch`` runs in its gloo processes.  They import the port
only (no JAX); each reads the inputs its test wrote with ``torch.save`` and
returns what the test compares."""

import argparse

import torch

from sinnerf_tpu_torch.parallel import ddp


def _port():
    """The port's modules the steps use (imported by the ranks that use
    them: ``rank_of``'s import nothing of the kernels' build)."""
    from sinnerf_tpu_torch.models import discriminator, nerf, vit
    from sinnerf_tpu_torch.render import renderer
    from sinnerf_tpu_torch.train import optimizers, step

    return argparse.Namespace(disc=discriminator, nerf=nerf, vit=vit, renderer=renderer, optimizers=optimizers,
                              step=step)


def rank_of(rank, world):
    """This rank's number and the world, as the rank sees them."""
    return rank, world, torch.distributed.get_rank(), torch.distributed.get_world_size()


def _state(inputs, case):
    """The replicated train state of ``case`` from the inputs' weights."""
    port = _port()
    models = {}
    for level, sd in inputs["nerf"].items():
        models[level] = port.nerf.NeRF(depth=inputs["depth"], width=inputs["width"])
        models[level].load_state_dict(sd)
    hp = argparse.Namespace(**case["hp"])
    g_params = [p for m in models.values() for p in m.parameters()]
    state = port.step.TrainState(models=models, opt_g=port.optimizers.get_optimizer(hp, g_params))
    if case["step2"]:
        disc = port.disc.Discriminator(-1, inputs["ndf"])
        disc.load_state_dict(inputs["disc"])
        v = port.vit.ViT(depth=inputs["vit_blocks"])
        v.load_state_dict(inputs["vit"])
        state.discriminator, state.vit = disc, port.vit.frozen(v)
        state.opt_d = port.optimizers.get_optimizer(hp, disc.parameters(), rate=0.2)
    return state


def _snapshot(state):
    out = {"params": {f"{lvl}.{k}": p.detach().clone() for lvl, m in state.models.items()
                      for k, p in m.state_dict(keep_vars=True).items()},
           "opt_g": _opt_state(state.opt_g)}
    if state.discriminator is not None:
        out["d_params"] = [c.weight_orig.detach().clone() for c in state.discriminator.convs()]
        out["d_u"] = [u.clone() for u in state.discriminator.u()]
        out["opt_d"] = _opt_state(state.opt_d)
        out["ref_feature"] = state.ref_feature.clone()
    return out


def _opt_state(opt):
    """Every tensor of the optimizer's state, parameter by parameter."""
    return [t.clone() for g in opt.param_groups for p in g["params"]
            for _, t in sorted(opt.state[p].items()) if isinstance(t, torch.Tensor)]


def steps_and_render(rank, world, path):
    """Each case's ``train_step``s on this rank's rows of the global batch
    with its draws, the gradients all-reduced (``ddp.gradient_hook``), and
    on rank 0 the same steps in one process on the whole batch; then the
    sharded render; then ``all_gather_rows`` of the rank numbers."""
    port = _port()
    inputs = torch.load(path, weights_only=False)
    out = {}
    batch = {k: torch.as_tensor(v) for k, v in inputs["batch"].items()}
    for name, case in inputs["cases"].items():
        state = _state(inputs, case)
        cfg = port.step.TrainConfig(render=port.renderer.RenderSettings(**inputs["render"]), **case["fields"])
        steps = []
        for draws, step2 in zip(case["render_draws"][rank], case["step2_draws"][rank]):
            state, aux = port.step.train_step(state, ddp.shard_rows(batch, rank, world), cfg, 0.0, draws,
                                              step2_draws=step2, grad_hook=ddp.gradient_hook(world))
            steps.append(dict(metrics=aux["metrics"], reduced=ddp.reduce_metrics(aux["metrics"], world),
                              **_snapshot(state)))
        out[name] = steps
        if rank == 0:  # the same steps in one process on the global batch
            state, out[f"{name}_one"] = _state(inputs, case), []
            for draws, step2 in zip(case["global_render_draws"], case["global_step2_draws"]):
                state, aux = port.step.train_step(state, batch, cfg, 0.0, draws, step2_draws=step2)
                out[f"{name}_one"].append(dict(metrics=aux["metrics"], **_snapshot(state)))
    r = inputs["render_case"]
    models = {level: port.nerf.nerf_from_state(sd) for level, sd in r["nerf"].items()}
    settings = port.renderer.RenderSettings(**r["settings"])
    out["render"] = port.renderer.render_chunked_sharded(models, torch.as_tensor(r["rays"]), settings, rank, world,
                                                         tile=r["tile"])
    out["gathered"] = ddp.all_gather_rows(torch.tensor([rank, 10 * rank]), world)
    return out


def resumed_rows(rank, world, hparams):
    """The ViT cache rows, step and first epoch a trainer resumed from
    ``hparams.ckpt_path`` holds on this rank."""
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    trainer = SinNeRFTrainer(hparams, rank, world)
    st = trainer.state
    return dict(ref_feature=st.ref_feature.clone(), ref_feature_valid=st.ref_feature_valid.clone(), step=st.step,
                start_epoch=trainer.start_epoch)


def built(rank, world, hparams):
    """The trainer built on this rank: its rank, world, batch sizes and the
    process group's view."""
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    trainer = SinNeRFTrainer(hparams, rank, world)
    return (trainer.rank, trainer.world, trainer.batch_size, trainer.global_batch_size,
            torch.distributed.get_rank(), torch.distributed.get_world_size())
