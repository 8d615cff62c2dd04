"""The full model's pipeline-parallel forward (counterpart of
``build_pp_forward`` in the JAX ``repro.launch.pp_dryrun``): the layers
pipelined over the mesh's ``pod`` axis (GPipe, point-to-point hops between
stages, ``parallel.pipeline``), the batch rows of every microbatch split
over the rules' batch axes inside each stage, and the embedding and the
vocab projection run whole on every rank.  The dry-run command line of the
JAX module reads XLA's HLO and is not ported here."""
from __future__ import annotations

from repro_torch.models import transformer as tfm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.pipeline import pipeline_forward
from repro_torch.parallel.sharding import batch_axes


def build_pp_forward(lm, cfg, mesh, rules, opts, n_microbatches: int):
    """Returns ``fwd(params, tokens) -> logits`` on this rank of ``mesh``
    (axes ``pod`` and the rules' batch axes).  ``params["layers"]`` holds
    this stage's contiguous slice of the stacked layers (num_layers /
    pod of them); the other leaves are whole.  ``tokens`` (B, S) is the
    global batch on every rank; every rank returns the whole (B, S, Vp)
    logits.  Each layer body runs under the checkpoint, as JAX's."""
    del lm
    n_stages = mesh.shape["pod"]
    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} layers do not split over "
                         f"{n_stages} stages")
    axes = tuple(a for a in batch_axes(mesh, rules) if a != "pod")
    dp = mesh.group(axes) if axes else None
    n_dp = mesh.axis_size(axes) if axes else 1

    def layer_fn(lp, h):
        h, _, _ = tfm._attn_layer(lp, cfg, h, opts, collect=False)
        return h

    body = tfm._remat(layer_fn, "full")

    def stage_fn(stage_params, x):
        h = x
        for i in range(_depth(stage_params)):
            h = body(tfm.layer_params({"layers": stage_params}, i), h)
        return h

    pipe = pipeline_forward(stage_fn, n_stages, "pod", mesh)

    def fwd(params, tokens):
        h = tfm.embed_inputs(params, cfg, tokens)
        b = h.shape[0]
        mb = b // n_microbatches
        if b % n_microbatches or mb % n_dp:
            raise ValueError(f"batch {b} does not split into "
                             f"{n_microbatches} microbatches over {n_dp} "
                             "data ranks")
        x_mb = h.reshape(n_microbatches, mb, *h.shape[1:])
        rows = mb // n_dp
        me = mesh.index(axes) if axes else 0
        out = pipe(params["layers"], x_mb[:, me * rows:(me + 1) * rows])
        out = coll.gather_from(out, 1, dp)
        return tfm.unembed(params, cfg, out.reshape(b, *h.shape[1:]),
                           opts.norm_impl)

    return fwd


def _depth(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]
