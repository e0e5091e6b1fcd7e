"""CLI alias: `python -m recalgorithm_tpu_torch.cli.two_tower` trains TwoTower
(``cli.main`` with ``--model TwoTower`` preset; every flag of ``cli.main``)."""

from recalgorithm_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(model_name="TwoTower")
