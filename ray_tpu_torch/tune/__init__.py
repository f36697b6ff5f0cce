"""ray_tpu_torch.tune — scalable hyperparameter tuning (counterpart of
ray_tpu/tune; reference: python/ray/tune)."""
from .space import (uniform, loguniform, quniform, randint, choice,
                    grid_search, generate_variants)
from .schedulers import (FIFOScheduler, ASHAScheduler, HyperBandScheduler,
                         MedianStoppingRule, PopulationBasedTraining)
from .tuner import (Tuner, TuneConfig, ResultGrid, Trial,
                    with_resources, with_parameters)
from .session import report, get_trial_id, StopTrial
from .stoppers import (CombinedStopper, ExperimentPlateauStopper,
                       FunctionStopper, MaximumIterationStopper, Stopper,
                       TimeoutStopper, TrialPlateauStopper)
from .loggers import Callback, CSVLoggerCallback, JsonLoggerCallback
from .search import BasicVariantGenerator, Searcher, TPESampler
from .trainable import Trainable

__all__ = ["uniform", "loguniform", "quniform", "randint", "choice",
           "grid_search", "generate_variants", "FIFOScheduler",
           "ASHAScheduler", "HyperBandScheduler", "MedianStoppingRule",
           "PopulationBasedTraining", "Tuner", "TuneConfig", "ResultGrid",
           "Trial", "report", "get_trial_id", "StopTrial", "Stopper",
           "MaximumIterationStopper", "TrialPlateauStopper",
           "ExperimentPlateauStopper", "TimeoutStopper", "CombinedStopper",
           "FunctionStopper", "Callback", "CSVLoggerCallback",
           "JsonLoggerCallback", "Searcher", "TPESampler",
           "BasicVariantGenerator", "Trainable", "with_resources",
           "with_parameters"]
