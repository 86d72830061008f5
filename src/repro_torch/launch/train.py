"""Training launcher: a thin CLI over `repro_torch.train.recipe.Recipe`.

Counterpart of `repro.launch.train`, with its flags one for one plus
`--device`. Runs the LUT-NN lifecycle on a registered arch, reduced
(`configs.reduce_arch`) to the given width and depth:

  dense pretrain -> convert (k-means init) -> soft-PQ QAT fine-tune
  [optionally distilling vs the frozen dense teacher] -> int8 deploy ->
  eval gate -> LUTArtifact written to --artifact-dir

and serves nothing itself: `python -m repro_torch.launch.serve --artifact
<dir>` serves what it writes. `--arch` takes the reference's choices (every
arch of ARCH_IDS and bert_base). Its data source gives token batches only,
so `--arch whisper_tiny` and `--arch qwen2_vl_7b` exit with the reason
(`train_refusal`) before anything is built: the enc-dec's encoder needs
frames and the vision-LM backbone embeddings. The reference's launcher
dies on both at the first dense step (ROADMAP, known reference faults);
both families train through the functions (`ModelBundle.loss`,
`train_step.make_train_step`, `core.convert`) with such batches. `--recipe recipe.json` runs a custom stage
list; `--dump-recipe` writes the flag-built default as a starting point. A
run is resumable: killing the process and re-invoking it with the same
--ckpt-dir resumes at the recorded stage and checkpoint step. It runs on
the card unless `--device cpu` asks for the CPU:

  python -m repro_torch.launch.train --lut --steps 20
  python -m repro_torch.launch.train --device cpu --lut --d-model 64 \\
      --layers 2 --vocab 128 --seq 32 --batch 8 --steps 6

Under `torchrun` (WORLD_SIZE > 1, on one host) every process joins a data
mesh of WORLD_SIZE ranks, rank RANK on card RANK mod the host's cards (on
the CPU with `--device cpu`), and the dense stage reduces its gradients in
int8 over it; rank 0 alone writes the checkpoints and the manifest. Only
that stage runs over ranks: `--grad-compression` is required and `--lut`
refused (the reference spans devices in the compressed dense stage alone,
`repro.train.recipe.DensePretrain`):

  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --grad-compression --steps 20
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import ARCH_IDS, ArchSpec, effective_plan, get_arch, reduce_arch
from repro_torch.data import MarkovLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.recipe import Recipe, default_recipe


def train_refusal(arch: ArchSpec) -> str | None:
    """Why the launcher cannot train `arch`, or None. Its data source
    (MarkovLM) gives {"tokens", "labels"} batches, as the reference's does;
    there the enc-dec's loss reads batch["frames"] (KeyError) and the
    vision-LM's forward reads embeds of None. The port refuses both rather
    than copy either fault; a data source of frames or embeddings would be a
    feature the reference lacks."""
    if arch.family == "audio":
        return (f"--arch {arch.name}: the launcher's data source gives token batches only, "
                f"so it could not feed the encoder its audio frames (the reference's launcher "
                f"dies at its first dense step on KeyError 'frames'); train it through "
                f"ModelBundle.loss / train_step.make_train_step with frame batches")
    if arch.takes_embeds:
        return (f"--arch {arch.name}: the launcher's data source gives token batches only, "
                f"so it could not give this model the embeddings it takes (the reference's "
                f"launcher dies at its first dense step reading embeds of None); train it "
                f"through ModelBundle.loss / train_step.make_train_step with embedding batches")
    return None


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ("bert_base",), default="qwen3_1p7b")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lut", action="store_true", help="run the full LUT pipeline")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--artifact-dir", default=None,
                    help="where the deployed LUTArtifact is written at the end of the --lut "
                         "pipeline (default: <ckpt-dir>_artifact); serve it with "
                         "repro_torch.launch.serve --artifact <dir>")
    ap.add_argument("--recipe", default=None, metavar="RECIPE_JSON",
                    help="run this serialized Recipe instead of the flag-built default "
                         "(stage/optimizer flags are then ignored)")
    ap.add_argument("--dump-recipe", default=None, metavar="PATH",
                    help="write the flag-built default recipe as JSON and exit (edit it, "
                         "then re-run with --recipe)")
    ap.add_argument("--distill-weight", type=float, default=0.0,
                    help="> 0 adds a KL term vs the frozen dense teacher to the soft-PQ stage")
    ap.add_argument("--distill-tau", type=float, default=2.0,
                    help="distillation softening temperature")
    ap.add_argument("--grad-compression", action="store_true",
                    help="EXPERIMENTAL: int8 error-feedback gradient reduce in the dense "
                         "stage, over the WORLD_SIZE ranks under torchrun, else this "
                         "process's one device (DESIGN.md §10.4)")
    ap.add_argument("--eval-max-regression", type=float, default=None,
                    help="fail the run if the deployed loss regresses more than this past "
                         "the dense teacher's")
    ap.add_argument("--spec-draft", default=None, metavar="KINDS",
                    help="deploy a TWO-plan artifact for speculative serving: the trained "
                         "plan ships as the 'draft' and the target keeps these "
                         "comma-separated kind patterns dense (e.g. 'attn/*'); serve with "
                         "repro_torch.launch.serve --spec-decode --draft-plan draft")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    if (refusal := train_refusal(get_arch(args.arch))) is not None:
        ap.error(refusal)
    artifact_dir = args.artifact_dir or args.ckpt_dir + "_artifact"
    if args.recipe is not None and args.dump_recipe is not None:
        ap.error("--dump-recipe writes the flag-built default recipe; combining it with "
                 "--recipe is a no-op copy — drop one")
    if not args.lut and args.recipe is None and (
            args.distill_weight > 0.0 or args.eval_max_regression is not None
            or args.spec_draft is not None):
        ap.error("--distill-weight/--eval-max-regression/--spec-draft configure the LUT "
                 "pipeline stages — they require --lut")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and (args.lut or (args.recipe is None and not args.grad_compression)):
        ap.error(f"WORLD_SIZE={world}: over ranks the launcher runs the dense stage with "
                 f"--grad-compression only, the one stage the reference spans devices in "
                 f"(repro.train.recipe.DensePretrain); the LUT stages run on one device")
    if args.recipe is not None:
        recipe = Recipe.load(args.recipe)
    else:
        recipe = default_recipe(
            steps=args.steps, lut=args.lut, artifact_dir=artifact_dir,
            distill_weight=args.distill_weight, distill_tau=args.distill_tau,
            grad_compression=args.grad_compression,
            eval_max_regression=args.eval_max_regression, spec_draft=args.spec_draft)
    if args.dump_recipe is not None:
        recipe.save(args.dump_recipe)
        print(f"wrote recipe ({recipe.describe()}) to {args.dump_recipe}")
        return

    base = get_arch(args.arch)
    arch = reduce_arch(base, d_model=args.d_model, n_layers=args.layers, vocab=args.vocab,
                       d_ff=0 if base.d_ff == 0 else 2 * args.d_model)
    data = MarkovLM(vocab=arch.vocab, seq_len=args.seq, batch=args.batch)
    if args.lut or args.recipe:
        print(f"replacement plan: {effective_plan(arch).describe()}")
    print(f"recipe: {recipe.describe()}")

    mesh = None
    if world > 1:
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        cards = max(torch.cuda.device_count(), 1)
        mesh = make_host_mesh(data=world, devices=["cpu"] * world if cpu else
                              [f"cuda:{r % cards}" for r in range(world)])
    try:
        result = recipe.run(arch, data, ckpt_dir=args.ckpt_dir, seed=args.seed,
                            device=args.device if mesh is None else mesh.device)
    finally:
        if mesh is not None:
            mesh.close()

    if result.inf_bundle is not None:
        deploy = next((e["result"] for e in result.manifest["stages"]
                       if e["kind"] == "deploy" and e["result"]), {})
        adir = deploy.get("artifact_dir", artifact_dir)
        print(f"wrote LUTArtifact to {adir} "
              f"(inspect: python -m repro_torch.serving.artifact {adir}; "
              f"serve: python -m repro_torch.launch.serve --artifact {adir})")


if __name__ == "__main__":
    main()
