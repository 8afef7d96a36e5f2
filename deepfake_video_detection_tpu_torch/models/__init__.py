"""The port's models; ``MTCNN`` and the GAN's ``Generator``,
``Discriminator`` and ``TextProjector`` are exported here as in the JAX
package."""

_EXPORTS = {"MTCNN": "mtcnn", "Generator": "vlm_gan", "Discriminator": "vlm_gan",
            "TextProjector": "vlm_gan"}


def __getattr__(name):
    # resolved on first use, so importing one model module does not load the rest
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(name)
