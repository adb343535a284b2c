"""The JAX package's model complexity, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/jax_flops.py [model ...]

Prints, per model at 224x224 (one image), the parameter count and GMACs of
``cotnet_tpu.ops.flops.get_model_complexity``: half of XLA's
``cost_analysis`` flops of the compiled forward, which counts elementwise
work as well as the convolutions, the products and the aggregation.  The
PyTorch port's count, ``cotnet_tpu_torch.ops.flops.get_model_complexity``,
counts the convolutions, the products and the aggregation only (its CLI
logs it, its bench reports it as ``gmacs_per_image``).  Compile-time
analysis only: no timing.
"""

import sys

import jax
import jax.numpy as jnp


def main(names):
    from cotnet_tpu.models import create_model
    from cotnet_tpu.ops.flops import get_model_complexity

    for name in names:
        gmacs, params = get_model_complexity(create_model(name),
                                             (1, 224, 224, 3), jnp.float32)
        print(f"{name}: {params} params, {gmacs:.4f} GMACs (XLA cost "
              f"analysis on {jax.default_backend()})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["cotnet50"])
