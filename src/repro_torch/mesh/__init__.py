"""Mesh + graph substrate: hex meshes, dual graphs, graph generators."""

from repro_torch.mesh.box import HexMesh, box_mesh, derive_edge_face_gids
from repro_torch.mesh.graphs import (
    Graph,
    build_csr,
    connected_components,
    connected_labels,
    csr_to_ell,
    dual_graph,
    dual_graph_from_incidence,
    extract_subgraphs,
    grid_graph_2d,
    grid_graph_3d,
)
from repro_torch.mesh.pebble import pebble_mesh
