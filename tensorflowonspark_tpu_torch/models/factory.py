"""Model registry (port of ``models/factory.py``): the transformer LM and
the ResNet family; the rest of the zoo follows in later slices (ROADMAP
A11)."""

from tensorflowonspark_tpu_torch.models import resnet, transformer

_REGISTRY = {
    "transformer": lambda device="cuda", seed=0, **kw:
        transformer.TransformerLM(transformer.TransformerConfig(**kw),
                                  device=device, seed=seed),
    "resnet18": resnet.ResNet18,
    "resnet34": resnet.ResNet34,
    "resnet50": resnet.ResNet50,
    "resnet101": resnet.ResNet101,
    "resnet152": resnet.ResNet152,
    "resnet50_v2": resnet.ResNet50V2,
    "resnet101_v2": resnet.ResNet101V2,
    "resnet152_v2": resnet.ResNet152V2,
}


def get_model(name, **kwargs):
    """Construct a registered model; ``device`` (default ``"cuda"``) and
    ``seed`` go to the model, every other keyword to its config (the
    transformer) or constructor (``num_classes``, ``width``, ``dtype``,
    ...). Raises with the known names otherwise."""
    if name not in _REGISTRY:
        raise ValueError(
            "unknown model {!r}; known: {}".format(name, sorted(_REGISTRY)))
    return _REGISTRY[name](**kwargs)
