"""Core PixHomology algorithm in PyTorch (whole-image path)."""
from repro_torch.core.packed_keys import (  # noqa: F401
    monotone_key32,
    pack_keys,
    packable_dtype,
    packed_index,
    resolve_merge_keys,
)
from repro_torch.core.pixhomology import (  # noqa: F401
    Diagram,
    PhaseA,
    batched_pixhomology,
    candidates,
    diagram_from_numpy,
    diagram_to_numpy,
    exact_candidates,
    exact_candidates_masked,
    keyed_steepest_pointers,
    merge_components,
    num_candidates,
    paper_candidates,
    phase_a,
    phase_b,
    phase_c,
    pixhomology,
    reindex_components,
    resolve_labels,
    resolve_labels_frontier,
    stack_diagrams,
    steepest_neighbors,
    total_order_keys,
    total_order_rank,
)
from repro_torch.core.reference import (  # noqa: F401
    diagram_to_array,
    persistence_oracle,
)
