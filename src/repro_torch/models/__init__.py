"""Models: the dense decoder-only LM (`transformer`), the SASRec
recommender and its embedding bag (`recsys`), the GNNs (`gnn`:
MeshGraphNet, GraphCast, NequIP, MACE), and their building blocks
(`common`)."""
