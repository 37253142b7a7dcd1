"""The port's configs against the JAX package's: the fields the two share,
the port's own options (those of granite-4.0-h-small, an arch the JAX
package lacks) held at their defaults on every twin."""

import dataclasses

#: archs of the port with no twin in the JAX package
PORT_ONLY_ARCHS = ["granite-4.0-h-small"]

#: fields of the port's config dataclasses that the JAX package's lack
PORT_ONLY_FIELDS = {
    "ModelConfig": ("mamba2", "rope", "attn_scale", "embedding_multiplier",
                    "residual_multiplier", "logits_scaling", "remat_unit"),
    "MoESettings": ("d_shared", "num_held", "first_held"),
}


def reference_fields(cfg):
    """``dataclasses.asdict(cfg)`` less the port's own options, each of
    which must sit at its default (it adds no operation there)."""
    out = {}
    own = PORT_ONLY_FIELDS.get(type(cfg).__name__, ())
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if f.name in own:
            assert value == f.default, (type(cfg).__name__, f.name, value)
            continue
        out[f.name] = reference_fields(value) if dataclasses.is_dataclass(value) else value
    return out
