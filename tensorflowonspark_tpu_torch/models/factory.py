"""Model registry (port of ``models/factory.py``): the transformer LM for
now; the rest of the zoo follows in later slices (ROADMAP A11)."""

from tensorflowonspark_tpu_torch.models import transformer

_REGISTRY = {
    "transformer": lambda device="cuda", seed=0, **kw:
        transformer.TransformerLM(transformer.TransformerConfig(**kw),
                                  device=device, seed=seed),
}


def get_model(name, **kwargs):
    """Construct a registered model; ``device`` (default ``"cuda"``) and
    ``seed`` go to the model, every other keyword to its config. Raises
    with the known names otherwise."""
    if name not in _REGISTRY:
        raise ValueError(
            "unknown model {!r}; known: {}".format(name, sorted(_REGISTRY)))
    return _REGISTRY[name](**kwargs)
