"""Graphs: the normalized user-item graph, kNN item graphs, edge pruning."""
