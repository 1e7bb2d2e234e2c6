"""L0: config model + KDL parser + template + loader + discovery.

The port's copy of ``fleetflow_tpu.core`` (the same public names). Public
interface mirrors crates/fleetflow-core/src/lib.rs:1-14. Nothing here
imports torch: the loader's parse pool may fork after CUDA is up, and its
workers only parse.
"""

from .errors import (CloudError, ConfigNotFound, ContainerError,
                     ControlPlaneError, FlowError, SolverError)
from .model import (RESOURCE_AXES, Backend, BuildConfig, CloudProviderDecl,
                    DeployConfig, FallbackPolicy, Flow, HealthCheck,
                    PlacementPolicy, PlacementStrategy, Port, Process,
                    ProcessState, Protocol, ReadinessCheck, RegistryRef,
                    ResourceQuota, ResourceSpec, RestartPolicy, ServerLabels,
                    ServerResource, Service, ServiceType, SpreadConstraint,
                    Stage, TenantSpec, Volume, WaitConfig)
from .kdl import KdlError, KdlNode, format_document, parse_document
from .parser import (parse_kdl_file, parse_kdl_string,
                     parse_port, parse_provider,
                     parse_server, parse_service, parse_stage, parse_tenant,
                     parse_volume, read_kdl_with_includes)
from .template import (TemplateProcessor, extract_variables_with_stage,
                       parse_dotenv)
from .discovery import (DiscoveredFiles, discover_files_with_stage,
                        find_project_root)
from .loader import (LoadDebug, expand_all_files, load_project,
                     load_project_from_root_with_stage,
                     prepare_template_processor)
