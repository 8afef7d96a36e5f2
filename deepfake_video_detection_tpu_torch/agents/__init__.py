from deepfake_video_detection_tpu_torch.agents.system import (  # noqa: F401
    AlertLevel,
    PredictionResult,
    Agent,
    InferenceAgent,
    DecisionAgent,
    MonitoringAgent,
    ActionAgent,
    MultiAgentOrchestrator,
)
from deepfake_video_detection_tpu_torch.agents.enhanced import (  # noqa: F401
    EnhancedDecisionAgent,
    EnsemblePrediction,
    DecisionAggregator,
)
from deepfake_video_detection_tpu_torch.agents.active_learning import ActiveLearner  # noqa: F401
from deepfake_video_detection_tpu_torch.agents.telemetry import TelemetryLogger  # noqa: F401
