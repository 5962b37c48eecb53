"""The library phase's merge quality: the posterior mean's CC with the true F.

chip_smoke.library_phase's model (chip_smoke.library_parts on the default
slice's problem: N_OBS observations, N_REFL reflections, N_IMAGES images,
the N_LAYERS-layer scaler of width D_META; RiceWoolfsonPosterior, a
normal ReferencePrior on 60 % of the reflections, NeuralNormalLikelihood
(3, 6)) trained STEPS full-batch steps from the seed, as train_slice
trains it, on the card or (--cpu) with the plain versions on the CPU.
Prints one JSON line: the CC over all reflections, over those the
reference prior observes and over the rest, the first and last loss, and
the training seconds. With --also-default, the default slice's model
(truncated normal, Wilson prior, normal likelihood) beside it.

    python tools/library_cc.py [--cpu] [--also-default] [--steps N]
        [--obs N --refl N --images N]
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def train(torch, dev, args, library):
    from careless_tpu_torch.device import seeded_generator

    model, params, trainer, inputs, f_true = cs.model_on(
        dev, args.seed, args.obs, args.refl, args.images, cs.D_META,
        cs.N_LAYERS)
    if library:
        model, params, trainer = cs.library_parts(model, params, trainer,
                                                  f_true, args.seed)
    t0 = time.perf_counter()
    trained, history = trainer.train(params, seeded_generator(args.seed, dev),
                                     inputs, args.steps, chunk_size=cs.CHUNK,
                                     device=dev)
    seconds = time.perf_counter() - t0
    mean = model.posterior.distribution(
        trained["posterior"]).mean().detach().cpu().numpy()
    out = dict(model="library" if library else "default",
               cc=float(np.corrcoef(mean, f_true)[0, 1]),
               loss_first_last=[history["loss"][0], history["loss"][-1]],
               train_s=seconds)
    if library:
        observed = model.prior.observed.cpu().numpy()
        for name, rows in (("cc_observed", observed),
                           ("cc_unobserved", ~observed)):
            out[name] = float(np.corrcoef(mean[rows], f_true[rows])[0, 1])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--also-default", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=cs.STEPS)
    ap.add_argument("--obs", type=int, default=cs.N_OBS)
    ap.add_argument("--refl", type=int, default=cs.N_REFL)
    ap.add_argument("--images", type=int, default=cs.N_IMAGES)
    args = ap.parse_args()

    import torch
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    runs = [train(torch, dev, args, True)]
    if args.also_default:
        runs.append(train(torch, dev, args, False))
    print(json.dumps(dict(device=str(dev), threads=torch.get_num_threads(),
                          steps=args.steps, obs=args.obs, refl=args.refl,
                          images=args.images, runs=runs)), flush=True)


if __name__ == "__main__":
    main()
