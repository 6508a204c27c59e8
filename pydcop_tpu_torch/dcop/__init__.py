from .objects import (
    AgentDef,
    BinaryVariable,
    Domain,
    ExternalVariable,
    Variable,
    VariableDomain,
    VariableNoisyCostFunc,
    VariableWithCostDict,
    VariableWithCostFunc,
    create_agents,
    create_binary_variables,
    create_variables,
)
from .dcop import DCOP, filter_dcop, solution_cost
from .relations import (
    AsNAryFunctionRelation,
    Constraint,
    NAryFunctionRelation,
    NAryMatrixRelation,
    UnaryFunctionRelation,
    constraint_from_str,
    join,
    projection,
    relation_from_str,
)
from .scenario import DcopEvent, EventAction, Scenario
from .yamldcop import dcop_yaml, load_dcop, load_dcop_from_file
