"""Model registry (port of ``models/factory.py``): every name the JAX
registry serves — the transformer LM, its MoE and pipelined variants, the
speculative-decoding draft ``gpt2-draft``, the MLP and linear regression,
the ResNets, and the zoo of ``models/cnn.py``, ``vgg.py``,
``inception.py`` and ``wide_deep.py``. ``register`` adds a user model, as
in the JAX package."""

from tensorflowonspark_tpu_torch.models import (
    cnn, inception, mlp, moe, pipelined, resnet, transformer, vgg, wide_deep,
)

# The shared speculative-decoding draft geometry: GPT-2-small's stem
# (width, heads, vocab, context 512) cut to 2 layers, so a draft can share
# the target's embedding and head; keywords override it.
GPT2_DRAFT = dict(vocab_size=50257, num_layers=2, num_heads=12, embed_dim=768,
                  mlp_dim=3072, max_seq_len=512, remat=False,
                  decode_attention="chunked")

_REGISTRY = {
    "transformer": lambda device="cuda", seed=0, **kw:
        transformer.TransformerLM(transformer.TransformerConfig(**kw),
                                  device=device, seed=seed),
    "gpt2-draft": lambda device="cuda", seed=0, **kw:
        transformer.TransformerLM(
            transformer.TransformerConfig(**{**GPT2_DRAFT, **kw}),
            device=device, seed=seed),
    "moe_transformer": lambda device="cuda", seed=0, **kw:
        moe.MoETransformerLM(moe.MoEConfig(**kw), device=device, seed=seed),
    "pipelined_transformer": lambda device="cuda", seed=0, **kw:
        pipelined.PipelinedTransformerLM(pipelined.PipelinedConfig(**kw),
                                         device=device, seed=seed),
    "mlp": mlp.MLP,
    "linear_regression": mlp.LinearRegression,
    "lenet": cnn.LeNet,
    "cifarnet": cnn.CifarNet,
    "alexnet": cnn.AlexNet,
    "overfeat": cnn.OverFeat,
    "inception_v1": inception.InceptionV1,
    "inception_v2": inception.InceptionV2,
    "inception_v3": inception.InceptionV3,
    "inception_v4": inception.InceptionV4,
    "inception_resnet_v2": inception.InceptionResNetV2,
    "resnet18": resnet.ResNet18,
    "resnet34": resnet.ResNet34,
    "resnet50": resnet.ResNet50,
    "resnet101": resnet.ResNet101,
    "resnet152": resnet.ResNet152,
    "resnet50_v2": resnet.ResNet50V2,
    "resnet101_v2": resnet.ResNet101V2,
    "resnet152_v2": resnet.ResNet152V2,
    "vgg16": vgg.VGG16,
    "vgg19": vgg.VGG19,
    "wide_deep": wide_deep.WideDeep,
}


def get_model(name, **kwargs):
    """Construct a registered model; ``device`` (default ``"cuda"``) and
    ``seed`` go to the model, every other keyword to its config (the
    transformers) or constructor (``num_classes``, ``width``, ``dtype``,
    ``image_size``, ``vocab_sizes``, ...). Raises with the known names
    otherwise."""
    if name not in _REGISTRY:
        raise ValueError(
            "unknown model {!r}; known: {}".format(name, sorted(_REGISTRY)))
    return _REGISTRY[name](**kwargs)


def register(name, constructor):
    """Add a user model to the registry (``constructor(**kwargs)``; it
    receives ``device`` and ``seed`` as the zoo's do). ``pipeline.TFModel``'s
    ``model_registrar`` calls this on each executor."""
    _REGISTRY[name] = constructor


def available():
    return sorted(_REGISTRY)
