"""The paper's Fig. 1a: the clocks, the training engines, the parameter and
data servers, the ring buffer and the three workers."""
from repro_torch.core.clock import RealClock, VirtualClock
from repro_torch.core.runtime import (AsyncTrainer, PartialAsyncDataPolicy,
                                      PartialAsyncModelPolicy, RunConfig,
                                      SequentialTrainer, Supervisor,
                                      SupervisorChain, clear_eval_cache)
from repro_torch.core.servers import (BackpressureError, DataServer,
                                      DataTransport, LocalBuffer,
                                      ParameterServer, ParameterTransport,
                                      ProcDataServer, ReplayBuffer,
                                      ShmParameterServer)
from repro_torch.core.workers import (DataCollectionWorker,
                                      ExplorationSchedule,
                                      ModelLearningWorker,
                                      PolicyImprovementWorker, ProcSpec)
