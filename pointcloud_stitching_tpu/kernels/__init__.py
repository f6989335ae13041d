from .nn_pallas import (nearest_neighbors_pallas,
                        nearest_neighbors_pallas_batched,
                        nearest_neighbors_pruned, nn_prepared, prepare_ref)

__all__ = [
    "nearest_neighbors_pallas", "nearest_neighbors_pallas_batched",
    "nearest_neighbors_pruned", "nn_prepared", "prepare_ref",
]
