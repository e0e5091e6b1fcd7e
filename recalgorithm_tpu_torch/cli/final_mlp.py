"""CLI alias: `python -m recalgorithm_tpu_torch.cli.final_mlp` trains FinalMLP
(``cli.main`` with ``--model FinalMLP`` preset; every flag of ``cli.main``)."""

from recalgorithm_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(model_name="FinalMLP")
