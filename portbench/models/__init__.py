"""The models the benchmark runs, one module each.

A configuration file (`portbench/configs/<name>.json`) names its model under
the required key `"model"`; the harness, the yardstick, the metric readers
and `calibrate.py` take everything model-specific from the module
`portbench.models.<model>`, so a configuration brings a new model in new
files alone.  A model module gives:

- `TINY`: {"config": {...}, "job": {...}}, the overrides of the
  configuration and the job at which `portbench/tests/` run it on the CPU;
- `modalities(cfg, job)`, `heads(cfg, job)`: the modalities a job's batches
  carry and the heads they label;
- `parameter_spec(cfg, modalities)`: [(name, shape, init)] of every
  parameter and buffer, in the port's state-dict names, in the order
  `inputs.make_weights` draws them (its inits);
- `make_batch(g, cfg, modalities, batch, heads, device)`: one batch in the
  port's loader layout, drawn from generator `g`;
- `pool_config(pool, heads)`: {configuration key: value} worked out from
  the pool's labels (a loss's class weights), merged into the
  configuration before anything is built;
- `draw_masks(g, cfg, job, modalities, device)`: one step's random draws
  (dropout), from the run's draws generator in the order the port takes
  them, as the reference takes them;
- `reference_trainer(weights, cfg, job, modalities, products)`: the plain
  reference's trainer on the benchmark's weights, with `params` ({name:
  tensor}) and `step(batch, masks)` -> (loss, {name: first gradient});
  `products` None computes as the configuration states, a precision name
  one lower (the control);
- `trainable_names(cfg, job, modalities)`: the leaves that train, in
  `parameter_spec`'s order;
- `build_trainer(cfg, job, modalities, weights, device, run_root)`: the
  port's `Trainer`, built through the port's own training entry and loaded
  with `weights`;
- `GRAD_GROUPS`: {check key: leaf-name prefix}, the per-group first-gradient
  checks (the worst leaf of the group) beside the whole model's;
- `launch_plan(cfg, job)`: {launch key: [(launches per step, (flops, bytes,
  products))]}, the hand-written kernels' launches in one training step;
  a launch key is the port's `launch_counts` key, `<kernel>` or
  `<kernel>.<dtype>`;
- `meta_step(cfg, job)`: a callable that runs one training step's forward
  and backward on meta tensors at the cell's shapes, whose operations
  `yardstick/flops.py` counts;
- optionally `family(kernel_name)`: the family of a kernel of the model's
  own (a metric reader's `fam`), or None; the frozen rules of
  `yardstick/families.py` file every kernel it leaves.
"""

import importlib

from ..yardstick import families


def load(cfg):
    """The model module that configuration `cfg` names."""
    return importlib.import_module(f"{__name__}.{cfg['model']}")


def family_of(cfg):
    """The rule that files a kernel of `cfg`'s runs under a family: its
    model's own rules ahead of the frozen ones."""
    own = getattr(load(cfg), "family", None)
    if own is None:
        return families.family
    return lambda name: own(name) or families.family(name)
