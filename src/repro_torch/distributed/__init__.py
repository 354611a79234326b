"""Distribution: logical-axis sharding, collectives, pipeline, elasticity."""
from .sharding import (
    P,
    Sharder,
    ShardingOptions,
    ShapeMesh,
    abstract_params,
    null_sharder,
    place_params,
    spec_tree_shardings,
)

__all__ = ["P", "Sharder", "ShardingOptions", "ShapeMesh", "abstract_params", "null_sharder",
           "place_params", "spec_tree_shardings"]
