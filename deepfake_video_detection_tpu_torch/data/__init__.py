"""The port's data pipeline; ``VideoClipsDataset`` is exported here as in
the JAX package."""


def __getattr__(name):
    # resolved on first use: the dataset pulls in decoding and detection
    if name == "VideoClipsDataset":
        from deepfake_video_detection_tpu_torch.data.video_dataset import VideoClipsDataset
        return VideoClipsDataset
    raise AttributeError(name)
