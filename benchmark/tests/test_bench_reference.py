"""The plain reference against the port's CPU path at tiny sizes: the
UNet forward, the tile grid and blend ramps, a whole scene, three train
steps and the evaluation's statistics; and the inputs the benchmark
makes. On the CPU the port runs
its kernels' plain versions and IEEE float32."""

import numpy as np
import pytest
import torch

from benchmark.drivers._shared import memory_dataset
from benchmark.inputs import city, geotiff, weights
from benchmark.reference import scene as ref_scene
from benchmark.reference import statistics as ref_stats
from benchmark.reference import train as ref_train
from benchmark.reference import unet as ref_unet

MODEL = {"input_channels": "geom-stereo", "depth": 3, "start_kernel": 8,
         "max_filter_depth": 16, "act_fn_encoder": "relu", "act_fn_decoder": "relu",
         "act_fn_bottleneck": "relu", "up_mode": "transpose", "do_BN": True,
         "bias_conv_layer": True, "outer_skip": True, "outer_skip_BN": False}


def program_unet(state, n_in=3, model=MODEL):
    from resdepth_tpu_torch.models import unet

    net = unet.UNet(unet.unet_config_from_settings({**model, "n_input_channels": n_in}))
    net.load_state_dict(state)
    return net


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("seed", [1, 2 ** 33 + 7])
@pytest.mark.parametrize("n_in", [1, 3])
def test_forward_agrees(seed, n_in, bias):
    from resdepth_tpu_torch.models.unet import apply_unet

    model = {**MODEL, "bias_conv_layer": bias}
    state = weights.make_state(model, n_in, seed, "cpu", 1.0)
    assert ("last_layer.bias" in state) == bias
    x = torch.randn(2, n_in, 32, 32, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        want = apply_unet(program_unet(state, n_in, model),
                          x.permute(0, 2, 3, 1))[..., 0]
        got = ref_unet.forward(state, x, MODEL["depth"])[:, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,tile,stride", [(96, 32, 16), (100, 32, 16), (97, 32, 24),
                                              (4096, 256, 128), (2048, 256, 128)])
def test_grid_and_ramps_agree(size, tile, stride):
    from resdepth_tpu_torch.geo.grid import create_regular_grid
    from resdepth_tpu_torch.ops.blend import weight_table

    area = {"x_extent": [(0, size - 1)], "y_extent": [(0, size - 1)]}
    positions, borders = create_regular_grid(area, tile, stride)
    wy, wx = weight_table(tile, stride, borders)
    ours = ref_scene.grid(size, size, tile, stride)
    assert [(y, x) for y, x, _, _ in ours] == [tuple(p) for p in positions]
    np.testing.assert_allclose(np.stack([w for _, _, w, _ in ours]), wy, atol=1e-7)
    np.testing.assert_allclose(np.stack([w for _, _, _, w in ours]), wx, atol=1e-7)


@pytest.mark.parametrize("stereo", [True, False])
def test_scene_agrees(stereo):
    from resdepth_tpu_torch.data.pipeline import DeviceRasters
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend

    n_in = 3 if stereo else 1
    made = city.synth_city(96, 96, 11, "cpu")
    orthos = made["orthos"] if stereo else None
    mean, std = (float(orthos.mean()), float(orthos.std())) if stereo else (0.0, 1.0)
    state = weights.make_state(MODEL, n_in, 11, "cpu", 1.0)
    ds = memory_dataset(made["dsm"].numpy(), None,
                        orthos.permute(1, 2, 0).numpy() if stereo else None, tile_size=32,
                        sampling_strategy="test", stride=16, dsm_std=5.0, ortho_mean=mean,
                        ortho_std=std)
    rasters = DeviceRasters(dsm_input=made["dsm"], dsm_target=None, orthos=orthos,
                            pairs=torch.as_tensor(ds.pairs_array, dtype=torch.int64),
                            nodata=city.NODATA)
    want = predict_linear_blend(program_unet(state, n_in), ds, device="cpu", batch_size=4,
                                rasters=rasters)
    got = ref_scene.refine_scene(state, MODEL["depth"], made["dsm"], orthos, tile=32,
                                 stride=16, dsm_std=5.0, ortho_mean=mean, ortho_std=std,
                                 nodata=city.NODATA).numpy()
    assert np.abs(got - want).max() <= 4 * np.spacing(np.float32(np.abs(want).max()))


def test_train_steps_agree():
    """Three steps of the port's train step at IEEE float32 ('high' on
    the CPU) against the reference's, on the same origins and draws."""
    from resdepth_tpu_torch.data.pipeline import DeviceRasters, GeneratorDraws, batch_spec_for
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)

    made = city.synth_city(96, 96, 5, "cpu")
    mean, std = float(made["orthos"].mean()), float(made["orthos"].std())
    ds = memory_dataset(made["dsm"].numpy(), made["gt"].numpy(),
                        made["orthos"].permute(1, 2, 0).numpy(), tile_size=32,
                        sampling_strategy="train", n_samples=12, seed=5, dsm_std=5.0,
                        ortho_mean=mean, ortho_std=std, augment=True)
    rasters = DeviceRasters(dsm_input=made["dsm"], dsm_target=made["gt"],
                            orthos=made["orthos"],
                            pairs=torch.as_tensor(ds.pairs_array, dtype=torch.int64),
                            nodata=city.NODATA)
    state0 = weights.make_state(MODEL, 3, 5, "cpu", 1.0)
    kwargs, dtype = select_train_precision("high", "float32", torch.device("cpu"))
    train_state = init_train_state(program_unet(state0), "Adam", 2e-4, 1e-5)
    step = make_train_step(batch_spec_for(ds), weighted_bn=False, compute_dtype=dtype,
                           **kwargs)
    draws = GeneratorDraws(torch.Generator().manual_seed(3))
    batches, losses = [], []
    for i in range(3):
        positions = ds.positions[4 * i:4 * i + 4]
        saved = draws.generator.get_state()
        bits = draws.dihedral_bits(4, "cpu")
        draws.generator.set_state(saved)
        losses.append(float(step(train_state, rasters, positions, ds.pair_indices[:4],
                                 np.zeros((4, 4), np.int32), np.ones(4, np.float32),
                                 draws)))
        batches.append((positions, bits))
        if i == 0:
            grad = {k: train_state.optimizer.state[p]["exp_avg"] / 0.1
                    for k, p in train_state.model.named_parameters()}
    ref = ref_train.train_steps(state0, MODEL["depth"], batches, lr=2e-4, weight_decay=1e-5,
                                dsm_std=5.0, rasters={"dsm": made["dsm"], "gt": made["gt"],
                                                      "orthos": made["orthos"]},
                                tile=32, ortho_mean=mean, ortho_std=std, nodata=city.NODATA)
    np.testing.assert_allclose(ref["losses"], losses, rtol=1e-5)
    for k, p in train_state.model.named_parameters():
        torch.testing.assert_close(ref["first_grad"][k], grad[k], rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(ref["params"][k], p.detach(), rtol=1e-4, atol=1e-6)
    stats = {k: b for k, b in train_state.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats and set(stats) <= set(ref["buffers"])
    for k, b in stats.items():
        torch.testing.assert_close(ref["buffers"][k], b, rtol=1e-4, atol=1e-6)


def test_city_is_the_seeds():
    a, b = city.synth_city(64, 80, 2 ** 40 + 3, "cpu"), city.synth_city(64, 80, 2 ** 40 + 3, "cpu")
    c = city.synth_city(64, 80, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dsm"], c["dsm"])
    assert a["orthos"].shape == (2, 64, 80) and a["building"].any() and a["water"].any()


def test_weights_are_the_seeds():
    a, b = (weights.make_state(MODEL, 3, 9, "cpu", 1.0) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(a) == set(program_unet(a).state_dict())


def test_geotiff_reads_and_writes_as_the_program_does(tmp_path):
    from resdepth_tpu_torch.geo import raster

    data = np.random.default_rng(0).normal(420.0, 9.0, (37, 53)).astype(np.float32)
    transform = (465000.0, 0.25, 0.0, 5247000.0, 0.0, -0.25)
    geotiff.write(str(tmp_path / "a.tif"), data, transform, city.NODATA)
    opened = raster.open_raster(str(tmp_path / "a.tif"))
    assert opened.geotransform == transform and opened.nodata == city.NODATA
    np.testing.assert_array_equal(opened.band(1), data)
    raster.write_raster(str(tmp_path / "b.tif"), data, like=opened, nodata=-9999,
                        dtype=np.float32)
    np.testing.assert_array_equal(geotiff.read(str(tmp_path / "b.tif")), data)


def test_statistics_agree_with_evaluate_performance(tmp_path):
    """The program's ``evaluate_performance`` on a tiny scene of GeoTIFFs:
    its report, read back, and the values it hands to the report match
    the plain statistics."""
    from resdepth_tpu_torch.evaluation import performance
    from resdepth_tpu_torch.utils.logging import setup_logger

    from benchmark import harness
    from benchmark.drivers.cli_scene import GEOTRANSFORM, reported

    made = {k: v.numpy() for k, v in city.synth_city(64, 80, 21, "cpu").items()}
    refined = made["dsm"] + np.random.default_rng(0).normal(0, 0.3, made["dsm"].shape)
    refined = np.where(made["dsm"] == city.NODATA, made["dsm"], refined).astype(np.float32)
    paths = {}
    for name, array, nodata in (("gt", made["gt"], city.NODATA),
                                ("dsm", made["dsm"], city.NODATA),
                                ("building", made["building"].astype(np.uint8), 255),
                                ("water", made["water"].astype(np.uint8), 255)):
        paths[name] = str(tmp_path / f"{name}.tif")
        geotiff.write(paths[name], array, GEOTRANSFORM, nodata)
    report = str(tmp_path / "report.txt")
    logger = setup_logger("benchmark_test_report", log_to_console=False, log_file=report)
    with harness.recording([(performance, "print_statistics")], reported) as recorded:
        performance.evaluate_performance(refined, paths["dsm"], paths["gt"], logger,
                                         path_building_mask=paths["building"],
                                         path_water_mask=paths["water"],
                                         logger_stats=logger)
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)
    classes = ref_stats.class_masks(made["building"].astype(np.uint8),
                                    made["water"].astype(np.uint8), 255)
    want = {"before": ref_stats.statistics(made["dsm"], made["gt"], city.NODATA, classes),
            "after": ref_stats.statistics(refined, made["gt"], city.NODATA, classes)}
    read = ref_stats.read_report(report)
    assert len(read) == 2 * len(ref_stats.CLASSES)
    assert ref_stats.widest_gap(read, want, recorded) <= 1e-9
    off = [dict(r, median=r["median"] + 0.002) if i == 3 else r for i, r in enumerate(recorded)]
    assert ref_stats.widest_gap(read, want, off) >= 0.002 - 1e-9
    assert ref_stats.widest_gap(read[1:], want, recorded[1:]) == float("inf")
