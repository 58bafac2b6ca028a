"""Models: SchNet backbone, dense GAT, and the regression fusion model."""
