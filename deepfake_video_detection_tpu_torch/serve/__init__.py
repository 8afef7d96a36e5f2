from deepfake_video_detection_tpu_torch.serve.predict import (  # noqa: F401
    Predictor,
    simple_english_message,
    simple_english_justification_200_words,
    load_calibration_threshold,
)
from deepfake_video_detection_tpu_torch.serve.loader import (  # noqa: F401
    load_model,
    attempt_autoload,
    build_autoload_candidates,
    LAST_LOAD_STATS,
)
from deepfake_video_detection_tpu_torch.serve.app import App, create_app  # noqa: F401
