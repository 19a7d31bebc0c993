from .dataset import GraphData, sbm_graph, rmat_graph, load_dataset, synth_reddit  # noqa: F401
