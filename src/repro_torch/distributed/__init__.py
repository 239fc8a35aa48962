from repro_torch.distributed import sharding
from repro_torch.distributed.cluster import ServingCluster, FaultEvent
from repro_torch.distributed.faults import (FaultPlan, FaultSpec,
                                            ReplicaFaults, ClusterFault,
                                            MigrationFaults)
from repro_torch.distributed.migration import (MigrationChannel,
                                               MigrationConfig,
                                               MigrationResult)
