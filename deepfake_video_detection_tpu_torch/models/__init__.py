"""The port's models; ``MTCNN`` is exported here as in the JAX package."""


def __getattr__(name):
    # resolved on first use, so importing one model module does not load the rest
    if name == "MTCNN":
        from deepfake_video_detection_tpu_torch.models.mtcnn import MTCNN
        return MTCNN
    raise AttributeError(name)
