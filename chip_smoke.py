#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``chaorec_tpu_torch``) on one CUDA card.

Drives the port's paths once, as a user would, each at its model's
published width with random weights from ``--seed``:

- CF_Diff (1034 tokens, d_model 16, 4 heads, 2 cross-attention rounds; the
  first combo of Model_YAML/CF_Diff.yaml) on a dataset of baby's size
  (12351 users x 4794 items): the serving path (export, serve) and the
  training path (the CLI's grid run: epochs of Adam steps, evaluation,
  early stopping, export of the best epoch);
- FREEDOM (dim 64, 2 layers, 1 modal layer, ii_topk 10, dropout 0.1; the
  one combo of Model_YAML/FREEDOM.yaml) on a dataset of sports' size
  (28940 users x 15207 items, 4096- and 384-wide item features): the
  CLI's grid run with BPR batches of 1024 edges, whose trainable feature
  tables are stepped by the row-sparse Adam kernel, then the export and
  serving of its embeddings;
- SGL (dim 64, 3 layers, lr 0.01, reg 0.1, ssl_alpha 1e-3, ssl_temp 0.1;
  the first combo of Model_YAML/SGL.yaml) and NCL (dim 64, 2 layers, lr
  1e-3, reg 1e-5, ssl_alpha 1e-5, ssl_temp 0.01, 200 k-means prototypes;
  the first combo of Model_YAML/NCL.yaml) on the same sports-sized set:
  the CLI's grid run with BPR batches of 1024 edges, whose full-catalog
  contrastive terms go through the streaming logsumexp kernels (forward,
  dq, dk), then (SGL) the export and serving of its embeddings;
- DGCF (dim 64, 3 layers, 2 factors, 1 routing iteration, lr 0.01, reg
  0.01, corDecay 0.01), DCCF (dim 64, 1 layer, 64 intents, lr 1e-3, reg
  1e-3, ssl_alpha 0.1, ssl_temp 1, cen_reg 1e-3) and MGAT (dim 64, its 256-
  and 100-wide towers, lr 0.1, reg 0.1), the first combo of each
  Model_YAML file, on the same sports-sized set: the CLI's grid run with
  BPR batches of 1024 edges, whose segment sums (and the backward of their
  gathers) go through the prefix-sum kernel, then (DGCF) the export of its
  best epoch, routing scores included, and the serving of its embeddings;
- the linear-GCN family on a dataset of beauty's size (15482 users x 8643
  items): LightGCN (dim 64, 2 layers, lr 1e-3, reg 1e-3, batch 1024, as
  bench.py's LightGCN leg) trained on the combined linear operator
  (ops/linear_prop.py, built on the card in bf16) through the CLI's run,
  then the export and serving of its embeddings; BPR, SimGCL, XSimGCL (on
  the operator too), NGCF and LayerGCN at their Model_YAML file's first
  combo. No TPU kernel lies on this path;
- the id-only models on the same beauty-sized set (with the loader's
  synthetic 4096- and 384-wide features), each at its Model_YAML file's
  first combo: MultVAE, MacridVAE (10 concepts, a 600-wide encoder) and
  DualVAE (5 aspects of 25) on the stateful BPR branch, DiffRec ([I + 10
  -> 1000 -> I], 5 steps) on the user-rows branch, DHCF, LightGODE,
  SelfCF, FKAN_GCF and MCLN on the plain one; DualVAE's rank lists (from
  its cached latents) and DiffRec's (-inf masked, a bf16 reverse process)
  exported and served. No TPU kernel lies on this path;
- the family trainers and the in-batch contrastive models on the same
  beauty-sized set, each at its Model_YAML file's first combo, through the
  CLI's ``trainer_cls`` dispatch: BSPM (training-free: the Gram R^T R on
  the card, its top-128 eigenvectors by the host's ARPACK, one scoring
  pass) and GFormer (dim 64, 1 layer, 1 PNN layer, 32 anchors, 4 heads,
  its graphs resampled on the host every 10 steps, a global-norm clip at
  20; its three full-catalog terms a step through the streaming logsumexp
  kernels), neither exported (their trainers keep no weights, as in the
  JAX package); HCCF (3 layers), LightGCL (2 layers, a rank-5 SVD), VGCL (4
  layers, k-means of 50 clusters a step) and GraphAug (3 layers, a MixHop
  view learner, 100000 random edges a view) on the standard trainer;
- AdaGCL (dim 64, 1 layer, reg 0.1, ssl_alpha 0.1, ssl_temp 0.1: a VGAE
  generator and a hard-concrete denoising generator, three losses and three
  Adams a batch) and Grade (dim 64, 5 layers, three VGAE generators over
  an id, a visual and a textual tower, three losses and four Adams a
  batch), each at its Model_YAML file's first combo on the same
  beauty-sized set through its own trainer, whose stacks over the doubled
  edge list run the prefix-sum kernel forward and backward; neither
  exported (their trainers keep no weights, as in the JAX package); and
  four multimodal towers on the standard trainer, each at its first combo:
  SLMRec (1 layer on the halved operator, the FAC tasks), VBPR (its raw
  4096-wide visual table trained), BM3 (2 layers, dropout targets) and
  MGCL (2 layers, a user table a modality), MGCL's embeddings exported and
  served. No kernel lies on the four towers' path;
- the rest of the multimodal towers on the standard trainer, each at its
  Model_YAML file's first combo on the same beauty-sized set: MMGCL (1
  layer, an edge-dropout and a modality-masking view a step), LGMRec (3
  layers, frozen features, a Gumbel-softmax hypergraph of 4 edges), MMGCN
  (4 rounds a modality on the self-loop R, the visual tower 256 wide, the
  textual one 384 wide first; frozen id and preference tables), MVGAE (2
  rounds, a product of experts, learning rate 0.1; frozen tables), POWERec
  (three 4-layer prompt towers on an R pruned each epoch), MENTOR (seven
  2-layer towers, the InfoNCE over the full (U x U) and (I x I) tables)
  and DDRec (3 layers filtered by similarity, its state the previous
  step's items; exported with that state and served). No kernel lies on
  their path;
- the towers on the host kNN graphs and the fixed-topology edge sums, each
  at its Model_YAML file's first combo on the same beauty-sized set: MGCN
  (2 U-I layers on the sparse graph, its bf16-rounded inputs; trainable raw
  features; sym-normalized 10-NN item graphs), SMORE (3 layers on the
  sparse graph, the rfft spectral fusion, the fusion graph the maximum of
  the two kNN graphs), GUME (3 layers over R, R^T and the I-I intersection
  graph, dense bf16 products, 192 wide) and GRCN (the doubled edge list's
  attention towers and the gated id convolutions, 10% edge dropout; its
  192-wide embeddings exported and served). No kernel lies on their path;
- the user co-occurrence graph's towers and LightGT, each at its Model_YAML
  file's first combo on the same beauty-sized set: DualGNN (two 2-layer
  towers, weighted-sum fusion, 10 co-occurrence neighbours a user redrawn
  each epoch), DRAGON ("cat" fusion, 40 neighbours, 2 passes of the 10-NN
  item graph mixed 0.6 image), COHESION (three 1-layer towers over bf16
  products with R, 40 neighbours, one item-graph pass; its embeddings
  exported and served) and LightGT (4 LightGCN layers feeding 4 encoder
  layers a modality over 50-item history samples; its rank lists over
  20-item evaluation subsets, redrawn each ranking pass, exported and
  served). The co-occurrence graph is B B^T on the card. No kernel lies on
  their path;
- the rebuild-gated trainer branch and MMSSL's adversarial trainer, each at
  its Model_YAML file's first combo on the same beauty-sized set: LATTICE
  (2 layers, the dense bf16 (I, I) item graph rebuilt from the projected
  features on each epoch's batch 0 and read detached after it, its
  projections, feature tables and modal weights stepped on a zero gradient
  off batch 0; frozen batches through the row operators R R^T and R^T R),
  MICRO (two learned 10-NN modal graphs, the sparse U-I graph, its
  full-catalog InfoNCE through the streaming logsumexp kernels, q rows of
  k's own table) and MMSSL (a WGAN-GP discriminator over (2B, I) rows with
  its Adam, then the generator's AdamW, optimizers made anew each epoch;
  dense fp32 (U, I) products); LATTICE's and MICRO's embeddings exported
  and served, MMSSL's export skipped (its trainer keeps no weights);
- the diffusion family trainers, each at its Model_YAML file's first combo
  on the same beauty-sized set, an epoch of three phases: DiffMM (two
  (I + 10 -> 1000 -> I) denoisers over the user rows with a fresh Adam, the
  modal U-I graphs rebuilt from a bf16 reverse process, 1 GCN layer and two
  full-catalog contrasts a step through the streaming logsumexp kernels)
  and MHRec (one hyperedge a train edge a modality, 22 nodes; two (U + I +
  10 -> 1000 -> U + I) denoisers, each with its own fresh Adam; the
  incidence rebuilt as each hyperedge's top 2 nodes of a 20-step bf16
  reverse process; 2 hypergraph attention layers a modality whose message
  sums and slot gathers go through the prefix-sum kernel, 3 GCN layers,
  four contrasts a step through the streaming logsumexp kernels); neither
  exported (their trainers keep no weights);
- checkpoint/resume through K1, K3 and K4 (FREEDOM and DGCF on the
  sports-sized set, CF_Diff on the baby-sized one: a resumed run gives the
  bits of an uninterrupted one), the supervisor relaunching a killed CLI
  child into its checkpoint, and the ``--profile_dir`` trace;
- the mesh (``--mesh_shape``), its ranks spawned by the CLI on this one
  card: FREEDOM as a world of one over NCCL and row-sharded over mp=3
  (three gloo ranks, K1 stepping each rank's (5069, .) shard of its
  tables), both bit-equal to one device; SGL split over dp=2 (two gloo
  ranks, K2 on each rank's half of a batch);
- the large catalogs, on synthetic sets of their exact shapes (5-13 train
  items a user drawn with the popularity skew of the sets above, as a
  Gumbel top-k on the card), each model at its Model_YAML file's first
  combo through the CLI's run: microlens (46420 users x 14079 items =
  653.5 M cells, above dense_prop_threshold's 600 M, the CLI's default data
  set): LightGCN and SGL on the segment graph (index_add_, no dense R, no
  combined operator; SGL's contrasts through the streaming logsumexp
  kernels at (1024, 46420) and (1024, 14079)), GUME on its dense bf16 R
  (its 8e8-cell budget); electronics (150179 x 51901): LightGCN ranking
  every user a 4096-user block at a time, DualGNN on the user
  co-occurrence graph's sparse path (above 1.5 B cells; its host build
  takes minutes), BSPM's randomized SVD (above 20000 items; on the first
  30000 users); these CLI runs in a child process beside the earlier
  phases; and the streaming logsumexp kernels at (1024, 150179) and (1024,
  51901).

Phases, each printing its own lines:

1. device   the card's name and power limit (nvidia-smi); fails without CUDA
2. build    compile csrc/fused_mha.cu, csrc/fused_mha_bwd.cu,
            csrc/row_adam.cu, csrc/streaming_lse.cu and csrc/prefix_scan.cu
            with nvcc (sm_90a), all at once, and print ptxas's registers
            and spills
3. kernel   fused_mha at keep 1.0 and 0.5 against mha_reference under the
            same mask (also at the serving batch, B = 1, and at 5000
            keys, where the forward walks K and V in tiles; at keep 1.0
            each also timed against scaled_dot_product_attention); its
            backward against autograd of mha_reference (also at B = 1 with
            ragged Lq and Lk, and at 4100 keys, past the 4096 its dq kernel
            stages at once);
            both timed against the plain version at the export chunk and
            the training batch shapes, and held to it at both (the
            backward at the training batch, slice by slice, and run twice
            there for the same bits; its keep-bit scratch's bytes);
            scaled_dot_product_attention timed at the export chunk;
            fused_row_adam (through table_adam_update) against
            row_adam_update at (15207, 4096) and (15207, 384), fp32 and
            bf16 storage, three steps with duplicates, sentinels, tile
            edges, rows 0 and N-1, B 2048 and 1; timed against its plain
            version and against zeros + index_add_ + a fused torch Adam,
            fp32 and bf16, with each shape's tile height and grid;
            streaming_logsumexp's forward, dq and dk kernels against the
            plain version and its autograd at SGL's user and item sides
            (1024 x 28940 and 1024 x 15207, E 64, temperature 0.1), a
            ragged batch (381 x 15207), NCL's prototypes (1024 x 200 at
            temperature 0.01, k without gradient: no dk launch) and a
            small ragged case (7 x 513); ptxas's registers and spills of
            the E = 64 engine's forward and backward (dq and dk) kernels,
            and the forward's blocks an SM; timed at the two SGL shapes
            and NCL's prototypes (forward and dq) against the plain
            version and the library route (torch.logsumexp(q @ k.T) and
            its autograd, two calls), each naming the kernel that ran
4. slice    CF_Diff export_artifact over every user (the kernel launch
            counts are reset just before and read just after), then the
            kernel path's scores against the plain path's and the CPU's
5. serve    Recommender + serve_http on 127.0.0.1: answers equal the
            artifact and hold no seen item; an embeddings artifact answers
            alike on the card and on the CPU
6. profile  device time by kernel over one CF_Diff export chunk
7. train    CF_Diff cli.run: 2 epochs at batch 1024 with --export_artifact
            (counts reset just before, read just after); per-epoch times
            and peak memory; the exported best epoch goes through phase 5
8. step     one CF_Diff training step at 8 users, kernel path against plain
            path with every dropout mask equal: loss and every gradient
9. profile  device time by kernel over one CF_Diff training step, and
            that step's peak device memory
10. freedom FREEDOM cli.run: 2 epochs with --export_artifact (counts reset
            just before, read just after: one fused_row_adam launch per
            table per step); per epoch the loss, pre_epoch (pruning and
            row operators), training and eval times and the peak memory;
            the exported embeddings served over HTTP equal their tables'
            top-k and hold no seen item
11. fstep   one FREEDOM training step, kernel path against plain path
            (row_adam_update) on the same batch and negatives: the loss,
            the tables, their moments and the dense params
12. profile device time by kernel over one FREEDOM training step and one
            pre_epoch; the time of the per-epoch products R R^T and R^T R
13. bf16    one FREEDOM epoch with --relaxed_precision bf16 (the tables
            and their moments stored in bf16, through the same kernel)
14. sgl     SGL cli.run on the sports-sized set of phase 10: 2 epochs with
            --export_artifact (counts reset just before, read just after:
            one forward, dq and dk launch per side per step); per epoch the
            loss, training and eval times and the peak memory; the
            exported embeddings served over HTTP
15. sstep   one SGL training step on a float32 R, kernel path against
            plain path on the same batch, negatives and view masks: the
            loss and gradients
16. profile device time by kernel over one SGL training step (bf16 R),
            split into K2, the propagation's GEMMs and fp32 copies, the
            gathers, scatters and bag sums, and the reductions
17. ncl     NCL cli.run: 1 epoch (four full-catalog terms a step, two of
            them over centroids without gradient: no dk launch for those)
18. nstep   one NCL training step on a float32 R, kernel path against
            plain path with equal prototypes: the loss and gradients
19. profile the same split over one NCL training step (bf16 R)
20. k4      prefix_cumsum against prefix_cumsum_reference and a float64
            prefix at the path shapes of phases 21-29 ((159101, 32) and
            (159101, 64) over the train edges; (318202, 256), (318202, 100)
            and (318202, 64) over the doubled edges), bf16 input, the 1-D
            seg_sum's (159101,) and small ragged shapes, each bit-identical
            on a second run (DGCF's shape over 10 runs); the kernel's
            registers and spills (ptxas); timed back to back, as every
            kernel, and as one CUDA graph of calls (the card's time without
            the host's issue time) against the plain version and
            torch.cumsum; seg_sum against zeros + index_add_ (printed)
21. dgcf    DGCF cli.run: 2 epochs with --export_artifact (counts reset
            just before, read just after: 24 prefix_cumsum launches a step,
            12 an eval or export forward); the exported embeddings served
22. gstep   one DGCF step, kernel path against plain path on the same
            batch, negatives and routing scores: loss, gradients, new S
23. profile device time by kernel over one DGCF step: K4, gathers and
            index_add_, GEMMs, reductions; the host's idle share
24-26.      DCCF: cli.run 1 epoch (8 launches a step, 2 an eval), one step
            on a float32 R kernel vs plain, the step profile
27-29.      MGAT: cli.run 1 epoch (18 launches a step, 6 an eval), one step
            kernel vs plain, the step profile and its peak memory
30. lightgcn LightGCN cli.run on the beauty-sized set: 2 epochs with
            --export_artifact (no kernel launch expected); the operator's
            build (seconds, bytes, peak memory; it must be bf16 on the card
            and the one the model trains on); per epoch the loss, training
            and eval walls, eval users per second and peak memory; the
            exported embeddings served over HTTP
31. linear  BPR, SimGCL, XSimGCL, NGCF and LayerGCN cli.run, 1 epoch each
            at their first combo on the same set: loss, walls, peak memory
            and (SimGCL, XSimGCL) the operator's build
32. lstep   one step of each of the six on the card against the same step
            on the CPU, on a seeded 2048 x 1024 set at dim 64 on a float32
            R, with equal params, batch, negatives and noise, keep mask or
            pruned R: the loss and every gradient; then LightGCN's step on
            its default bf16 operator, card against CPU
33. profile device time by kernel and idle share over one step of each of
            the six at the beauty-sized set (bf16 operator and R), split
            into the index kernels, the GEMMs and the copy kernels (bdot's
            fp32 casts); peak memory
34. determinism  each of the 53 trained models twice from a fresh trainer on
            one seed at the path's shapes (CF_Diff, DiffRec, DiffMM and MHRec
            one epoch, the others 20 steps), then an evaluation: equal loss
            bits and equal rank lists, one JSON line per model with both runs' seconds;
            the seconds phases 30-33 and the family's six models here added
35. idonly  MultVAE, MacridVAE, DualVAE, DiffRec, DHCF, LightGODE, SelfCF,
            FKAN_GCF and MCLN cli.run, 1 epoch each at their first combo on
            the beauty-sized set: loss, training and eval walls, eval users
            per second, peak memory (no kernel launch expected)
36. idserve DualVAE's and DiffRec's exported rank lists (phase 35's best
            epoch) served over HTTP: answers equal the artifact and hold no
            seen item; over the whole catalog the seen items rank last, at
            the model's mask value (-inf for DiffRec, whose bf16 reverse
            process is also held to 2^-6 of the float32 one's largest score)
37. idstep  one step of each of the nine on the card against the same step
            on the CPU, on phase 32's seeded 2048 x 1024 set on a float32
            R, with equal params, batch, state and draws, the card's held to
            the CPU's side of every ReLU kink (Kinks): the loss, every
            gradient and the new state to phase 32's bounds; the card's step
            again with TF32 products, the control, which MCLN's must fail
38. idprofile device time by kernel group and idle share over one step of
            each of the nine at the beauty-sized set, and its peak memory;
            the seconds phases 35-38 and the nine's determinism runs added
39. family  BSPM, GFormer, HCCF, LightGCL, VGCL and GraphAug cli.run at
            their first combo on the beauty-sized set, BSPM one pass (its
            spectral build and evaluation seconds), the others 1 epoch
            (loss, training and eval walls, eval users per second, peak
            memory); GFormer's K2 launches (3 terms a step, each kernel
            counted; none elsewhere); BSPM's and GFormer's
            --export_artifact skipped with the JAX CLI's warning
40. k2gf    the streaming logsumexp at GFormer's three shapes (q rows of
            the user or the item table against that table, whose gradient
            sums dq and dk; the users against the item table) against the
            plain version and its autograd at phase 3's gates, then each
            kernel's time beside the plain version's, the library route's
            and its bound
41. famstep one step of each trained model on the card against the CPU on
            phase 32's seeded set (float32 R, equal params, batch and
            draws; the card held to the CPU's side of every ReLU, clip
            bound, hard cut and k-means assignment: Kinks, Cuts), GFormer
            over one group of 10 steps on the CPU's sampled graphs; BSPM's
            scores card against CPU, and two card builds' bits (a JSON line)
42. famprofile device time by kernel group and idle share over one step of
            each trained model (GFormer's host resample timed apart) and
            one BSPM evaluation chunk at the beauty-sized set, peak memory;
            the seconds phases 39-42 and the five's determinism runs added
43. family2 AdaGCL and Grade cli.run at their first combo on the
            beauty-sized set through their own trainers, 1 epoch each:
            loss, training wall (and a step's), eval wall, eval users per
            second, peak memory; K4's launches against the count read off
            the code (scan_launches: 18 L - 3 a step for AdaGCL, 18 L for
            Grade, L an evaluation), no other kernel;
            --export_artifact skipped with the JAX CLI's warning
44. k4ag    K4 at their shape, (2E, dim_E) over the doubled edges, against
            prefix_cumsum_reference and a float64 prefix under phase 20's
            gate, the same bits twice; its time beside the plain version's,
            torch.cumsum's and the bound
45. towers  SLMRec, VBPR, BM3 and MGCL cli.run at their first combo, 1
            epoch each (no kernel launch expected); MGCL's exported
            embeddings served over HTTP
46. fam2step one step of each of the four on the card against the CPU on
            phase 32's seeded set with features (float32 R, equal params,
            batch and draws, Kinks and Cuts); AdaGCL and Grade over two
            batches (Grade on the CPU's kNN graph: the card's own top-k may
            pick another neighbour where two nearly tie; the items counted),
            each optimizer step of the card's from the CPU's params
            and state, the CPU's prefixes in K4's own summation order: the
            losses and each optimizer step's gradient (the larger of the
            step bounds and 4 x the CPU step's spread from inputs nudged by
            2^-24), how far K4's order moves them from prefixes rounded
            once (printed), the
            card's Adam steps against float64 Adam on its own gradient (the
            entries Adam's normalization leaves apart from the CPU's
            counted), the optimizer order and counts, K4 a batch
47. fam2profile device time by kernel group (K4 among them) and idle share
            over one step of each of the six at the beauty-sized set, peak
            memory; the seconds phases 43-47 and the six's determinism runs
            added
48. towers2 MMGCL, LGMRec, MMGCN, MVGAE, POWERec, MENTOR and DDRec cli.run
            at their first combo, 1 epoch each (no kernel launch
            expected); MMGCN's and MVGAE's frozen tensors bit-equal to a
            fresh build's after training; DDRec's best epoch exported with
            its state and served over HTTP
49. tw2step one step of each of the seven on the card against the CPU on
            phase 32's seeded set with features (float32 R, equal params,
            batch, frozen tensors and draws; MENTOR and DDRec on the CPU's
            kNN graph; POWERec on epoch 0's pruned R; the card held to the
            CPU's side of every LeakyReLU, clamp, similarity cut, weakest
            modality and noise sign: Kinks, Cuts), DDRec over two batches
            (the second gated by the first's state): the loss, every
            gradient and the new state; beside each, not a gate, how far
            the CPU's own step moves from params nudged by 2^-24
50. tw2profile device time by kernel group and idle share over one step of
            each of the seven at the beauty-sized set, peak memory; MENTOR's
            full-table InfoNCE (forward and backward at its (U, 2 dim_E) and
            (I, 2 dim_E) shapes) timed alone, its share of MENTOR's step;
            the seconds phases 48-50 and the seven's determinism runs added
51. towers3 MGCN, SMORE, GUME and GRCN cli.run at their first combo, 1
            epoch each (no kernel launch expected); each build's seconds
            and peak memory (GUME's: its host kNN over the full similarity,
            its dense bf16 R, I-I and kNN graphs' bytes); GRCN's best epoch
            exported and served over HTTP
52. tw3step one step of each of the four on the card against the CPU on
            phase 32's seeded set with features (float32 graphs, equal
            params, batch and draws; the CPU's kNN graphs; the card held to
            the CPU's side of every LeakyReLU and ReLU, the 1e-16 clamp,
            GRCN's strongest modality, GUME's noise signs and absolute
            gaps: Kinks, Cuts): the loss and every gradient; beside each,
            not a gate, the CPU's own step's spread from params nudged by
            2^-24
53. tw3profile device time by kernel group and idle share over one step of
            each of the four at the beauty-sized set, peak memory; GUME's
            fp32 copies of its dense bf16 graphs in bdot's backward timed
            alone, their share of its step; the seconds phases 51-53 and
            the four's determinism runs added
54. towers4 DualGNN and DRAGON cli.run at their first combo, 2 epochs each
            (no kernel launch expected); the user co-occurrence build's
            seconds and peak memory on the card, equal to the host's
            sparse path (scipy), and each epoch's host topk_sample seconds;
            one step of each under the profiler (device time by kernel
            group, idle share, peak memory)
55. cohesion COHESION likewise, its best epoch exported and served over HTTP
56. lightgt LightGT likewise, its evaluation subsets drawn once before each
            ranking pass and not at export, its rank lists exported and
            served over HTTP
57. tw4step one step of each of the four on the card against the CPU on
            phase 32's seeded set with features (float32 U-I graph, equal
            params, batch and LightGT's draws; the user graph built on each
            and required equal; the CPU's kNN graph; the card held to the
            CPU's side of every LeakyReLU: Kinks): the loss and every
            gradient, COHESION's (bf16 operands on both sides) at the
            bf16-operator bound; beside each, not a gate, the CPU's own
            step's spread from params nudged by 2^-24; the seconds phases
            54-57 and the four's determinism runs added
58. rebuild LATTICE and MICRO cli.run at their first combo, 1 epoch each
            (MICRO's K2 launches: 2 terms a step, each kernel counted; none
            elsewhere); each build's seconds and peak memory, the row
            operators' and the carried graph's bytes; each best epoch
            exported and served over HTTP; the batch-0 graph build alone
            (seconds, peak), then one batch-0 step and one frozen step
            under the profiler (device time by kernel group, idle share,
            peak memory)
59. mmssl  MMSSL cli.run through its trainer_cls, 1 epoch (no kernel
            launch expected), --export_artifact skipped with the JAX CLI's
            warning; its dense tables' bytes; one step under the profiler
60. k2micro the streaming logsumexp at MICRO's shape ((I, 64) q rows of a
            (2I, 64) k, temperature 0.5; dq and dk both reach q's table)
            against the plain version and its autograd at phase 3's gates,
            then each kernel's time beside the plain version's, the library
            route's and its bound
61. rgstep batch 0 (the graph build) and batch 1 (on the CPU's batch-0
            graph) of LATTICE and MICRO at float32 and bfloat16 on the card
            against the CPU on phase 32's seeded set, the card on the CPU's
            kNN picks and original graphs (KnnPins): the loss, every
            gradient (the gated params' nonzero on batch 0 only), the built
            graph, K2's launches (MICRO at bf16: 2 of each a batch); MMSSL
            over two batches, each optimizer step (the discriminator's
            Adam, the AdamW) of the card's from the CPU's params and state:
            gradients within the larger of the step bounds and 4 x their
            spread, the card's steps against float64 Adam and AdamW on its
            own gradient, the new count matrices equal; the seconds phases
            58-61 and the three's determinism runs added
62. diffmm DiffMM cli.run through its trainer_cls, 1 epoch (K2 launches: 2
            terms a phase-C step, each kernel counted; none elsewhere), the
            epoch split into phases A, B and C (the device synchronized at
            each end), --export_artifact skipped with the JAX CLI's warning;
            its build's seconds and peak; one phase-A step and one phase-C
            step on the graph the run rebuilt under the profiler (device
            time by kernel group, idle share, peak memory)
63. mhrec  MHRec likewise (K2: 4 terms a phase-C step; K4: 8 a phase-C
            step, counted by input dtype)
64. k2diff the streaming logsumexp at the family's two contrast shapes
            (1024 rows of one tower against the U or I rows of another,
            temperature 0.1) against the plain version and its autograd at
            phase 3's gates, then each kernel's time beside the plain
            version's, the library route's and its bound
65. k4mh   K4 at MHRec's shape (He x 2 slots by 64) with fp32 and bf16
            input against prefix_cumsum_reference and a float64 prefix
            under phase 20's gate, the same bits twice, and its times;
            seg_edge_weighted_sum at that shape against its float64 sum
66. dfstep each optimizer step of DiffMM and MHRec over two batches of
            each phase (phase A's denoiser Adams, phase C's main Adam) on the
            card against the CPU on phase 32's seeded set at float32, the
            card from the CPU's params and state, on the CPU's draws, phase-B
            picks and item kNN (the rows whose card picks differ counted):
            gradients within the larger of the step bounds and 4 x their
            spread, the card's Adam steps against float64 Adam on its own
            gradient, the other params unchanged, K2's and K4's launches a
            step; the seconds phases 62-66 and the two's determinism runs
            added
67. resume FREEDOM (K1, fp32 tables), CF_Diff (K3, dropout) and DGCF (K4,
            its routing scores), each at its first combo through its
            trainer with a checkpoint each epoch: 3 epochs uninterrupted,
            and 2 epochs then a resume to 3 from the same directory; equal
            loss bits, best metrics, params, Adam state, tables' moments and
            step count, model state and generator state; the resumed run's
            launches exactly one epoch's (counts reset just before, read
            just after); save and restore seconds, checkpoint bytes, peak
            memory
68. elastic (started before phase 48 and run beside phases 48-67, its
            wall under that load; collected here) the sports-sized set
            written in the loader's format; python -m
            chaorec_tpu_torch.elastic --retries 2 -- python -m
            chaorec_tpu_torch.cli --Model FREEDOM ... --num_epoch 3
            --checkpoint_every 1; the CLI child SIGKILLed as soon as
            combo_0/step_1 exists: the supervisor relaunches it and exits
            0, the relaunched log starts with its resume, its epoch lines
            equal phase 67's uninterrupted run's, the grid cursor records
            combo 0
69. trace  FREEDOM 2 epochs with --profile_dir: epoch 2's Chrome trace holds
            one row_adam_kernel event a launch of that epoch; its bytes,
            and epoch 2's wall with and without the profiler
70. mesh   (the three CLI children of 70-72 start together before phase 34,
            with the sports-sized set written in the loader's format, and
            run beside phases 34-69; their walls are under that load)
            K1 at rank 0's mp=3 shards (5069, 4096) and (5069, 384), the
            batch's rows it does not own mapped to the padding id, held to
            row_adam_update and timed; K2 at SGL's dp=2 half batch (512
            rows against the (28940, 64) and (15207, 64) tables) held and
            timed; FREEDOM and SGL 1 epoch on one device (the references);
            then python -m chaorec_tpu_torch.cli --Model FREEDOM ...
            --mesh_shape dp=1,mp=1 (the CLI spawns a world of one over
            NCCL): loss bits, rank lists and checkpoint (params, Adam,
            tables' moments and count, generator) equal to one device's
71. mesh   the same with --mesh_shape dp=1,mp=3: three gloo ranks on the
            card, each holding (5069, .) shards of v_feat, t_feat, their
            moments and the item table; bit-equal to one device; each
            rank's launches one device's (K1 on every rank); each rank's
            peak memory beside one device's
72. mesh   python -m chaorec_tpu_torch.cli --Model SGL ... --mesh_shape
            dp=2: two gloo ranks, each stepping its half of every batch
            (K2 at q = 512 rows), gradients summed over dp; the loss within
            1e-4 of one device's, the rank lists' mean top-50 overlap with
            one device's >= 0.98, each param within 4x the drift that
            permuting each batch's rows gives one device (an epoch run here
            with the rows permuted: the same sums in another order), the
            replicated params bit-equal on both ranks, each rank's launches
            one device's
73. catalog (73-78 run in a child process, ``chip_smoke.py
            --catalog_child``, started before phase 34 beside phases 34-72
            and collected after 72, its lines printed then; each ends with a
            line of its wall, peak device memory, branch and kernel
            launches) LightGCN cli.run on the
            microlens-sized set, 2 epochs with --export_artifact: the
            segment graph without a dense R or a combined operator (U x I
            above dense_prop_threshold); each ranking pass's seconds and
            peak, no score block wider than 4096 users; the export served
            over HTTP; one step profiled (device time by kernel group)
74. catalog SGL cli.run there, 1 epoch (K2 launches: 2 terms a step, each
            kernel counted), on the segment graph; a step profiled; then, in
            this process after the child, K2 at (1024, 46420, 64) and (1024,
            14079, 64), temperature 0.1, against the plain version and its
            autograd at phase 3's gates, then each kernel's time beside the
            plain version's, the library route's and its bound
75. catalog GUME cli.run there with the loader's synthetic features, 1
            epoch: its dense bf16 R (U x I within its 8e8-cell budget, 1.31
            GB); a step profiled and its fp32 copies in bdot's backward timed
76. catalog LightGCN cli.run on the electronics-sized set, 1 epoch with
            --export_artifact: the segment graph, no operator; the ranking
            pass over 150179 users a 4096-user block at a time (its seconds
            and peak, below one (U, I) fp32 table); the export served; a
            step profiled
77. catalog DualGNN cli.run on the
            electronics-sized set with the loader's synthetic features, 1
            epoch: the user co-occurrence graph's sparse path (U x I above
            1.5 B cells; its host seconds and host peak, traced by
            tracemalloc), topk_sample's seconds, a step profiled
78. catalog BSPM cli.run on that set's first 30000 users, every item (the
            item count picks the branch): the randomized SVD of R (counted),
            one scoring pass and the export skipped, as phase 39
79. catalog K2 at (1024, 150179, 64) and (1024, 51901, 64) held and timed
            as in 74

Then one JSON line about the kernels (each with its time, its plain
version's, its bound and, where one PyTorch call computes the same
function, that call's time), and last the result line ``{"ok": true,
"device": {...}}``. Any failed check raises and the script exits non-zero
without the result line.

    python3 chip_smoke.py [--seed 0] [--data_root DIR] [--out_dir log]

With ``--data_root`` pointing at a directory holding ``baby/train.npy``,
``sports/train.npy``, ``beauty/train.npy`` etc., the real datasets are used instead of the
synthetic ones. TF32 is off for matmuls and convolutions throughout (but
for phase 37's control): the plain versions the kernels are held to sum in
full fp32, as the kernels do.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import hashlib
import inspect
import json
import logging
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Model_YAML/CF_Diff.yaml, first grid combo (``dims`` is unused by CAM_AE).
MODEL_CONFIG = dict(Model="CF_Diff", learning_rate=0.001, noise_scale=0.1,
                    noise_min=0.0005, noise_max=0.005, steps=10)
DATASET = "baby"
# Model_YAML/FREEDOM.yaml's one combo is what cli.run reads; the rest of
# the configuration is the Config defaults (dim_E and feature_embed 64,
# batch 1024, graph_compute_dtype bfloat16), as bench.py's FREEDOM leg.
FREEDOM_DATASET, FREEDOM_EPOCHS = "sports", 2
KERNELS = ("fused_mha", "fused_mha_bwd", "row_adam", "streaming_lse", "prefix_scan",
           "csr_spmm")
# fp32 attention over 1034 keys with inputs ~N(0, 1): the kernel's online
# softmax sums in another order than the reference's; 1e-5 is expected,
# with or without dropout (both draw the same Philox mask).
ATTN_TOL = 1e-5
# Backward: max abs error over the largest entry of each plain gradient.
# dK and dV sum up to 1034 query rows in fp32, in another order.
BWD_REL_TOL = 1e-5
# CF_Diff scores after 10 diffusion steps, kernel path against plain path
# (both on the card) and against the CPU plain path: absolute bound.
SCORE_TOL = 1e-4
TOPK_AGREE_MIN = 0.98  # mean top-k overlap of two rankings of the same scores
# One training step, kernel path against plain path with equal masks: the
# loss to rtol 1e-5; each gradient entry to rtol 1e-4 of its tensor's
# largest entry plus 1e-6 of the whole gradient's largest (the SNR weights
# make entries span ~10 decades; as tests/test_torch_cf_diff.py holds it).
STEP_LOSS_RTOL, STEP_RTOL, STEP_ATOL = 1e-5, 1e-4, 1e-6
# Row-sparse Adam: the JAX package's own tolerances for it
# (tests/test_pallas_row_adam.py), fp32 math in another order (the kernel
# contracts b1 m + (1 - b1) g into one fma; duplicate rows' gradients are
# summed by atomics in any order). bf16 storage: one bf16 ulp of the stored
# value on top of that, since a moment that nearly cancels (b1 m close to
# -(1 - b1) g) is small enough for the fp32 difference to exceed its ulp.
ROW_P_TOL, ROW_V_TOL = dict(rtol=2e-5, atol=2e-7), dict(rtol=2e-5, atol=1e-9)
ROW_ADAM_SHAPES = (("v_feat", (15207, 4096)), ("t_feat", (15207, 384)))
ROW_ADAM_LR = 1e-3  # FREEDOM's learning rate
# The card's published peaks (NVIDIA's H100 SXM data sheet, dense, at 700 W)
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 67e12, 989e12, 3.35e12
# The streaming logsumexp (B, N, E, temperature, k needs a gradient): SGL's
# user and item sides at batch 1024 on sports, a ragged batch of 381 rows
# (the real rows of an epoch's last batch, 159,101 edges = 155 x 1024 +
# 381; the trainer pads that batch to 1024 as the JAX package does), NCL's prototype term (200 centroids,
# N below one 512-row TPU tile, no gradient), and a small ragged case. q is
# unit rows over the temperature, k unit rows, as the models give them.
LSE_SHAPES = ((1024, 28940, 64, 0.1, True), (1024, 15207, 64, 0.1, True),
              (381, 15207, 64, 0.1, True), (1024, 200, 64, 0.01, False),
              (7, 513, 64, 0.1, True))
LSE_MAIN = {"user": LSE_SHAPES[0], "item": LSE_SHAPES[1]}
# timed too: NCL's prototype term (forward and dq; its k needs no gradient)
LSE_TIMED = {**LSE_MAIN, "prototypes": LSE_SHAPES[3]}
# Forward: rtol/atol 1e-5 against torch.logsumexp of the fp32 product (the
# kernel sums the logits and the exps in another order). dq and dk: max abs
# error within 1e-5 of the largest plain entry (as BWD_REL_TOL), times
# max(1, 0.1 / temperature): an fp32 logit of unit rows over t carries
# rounding of about 1e-7 / t, and p = exp(logit - lse) carries it relatively.
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
LSE_BWD_REL_TOL = 1e-5
SSL_EPOCHS = {"SGL": 2, "NCL": 1}
# full-catalog logsumexp terms per step, and those whose k needs a gradient
SSL_TERMS = {"SGL": (2, 2), "NCL": (4, 2)}
SEG_EPOCHS = {"DGCF": 2, "DCCF": 1, "MGAT": 1}
# One step of a segment-sum model, kernel path against plain path. A
# segment sum is the difference of two fp32 prefixes, whose error is a few
# ulp of the running total, not of the segment (the CAVEAT of
# chaorec_tpu/ops/ell.py:370-381), and DGCF normalizes propagated rows,
# some of them near zero, in its routing update: two correct summation
# orders can part by more than the other models' step bounds. Each output
# (the loss, each gradient, DGCF's new S) is held to the larger of those
# bounds (S, O(1) entries: 1e-5 absolute) and SPREAD_FACTOR times the
# spread between the plain path and a path whose prefixes are summed in
# float64 and rounded once, which measures how far two correct orders of
# this step's sums drift apart.
S_STEP_ATOL, SPREAD_FACTOR = 1e-5, 4.0
# K4 at DGCF's shape is run this many times for the same bits: each run's
# tiles find their look-back windows by the timing of that run.
K4_BIT_RUNS = 10
# The forward is also held and timed at CF_Diff's serving batch (B = 1) and
# at 5000 keys, past the 4096 that csrc/fused_mha.cu stages at once.
ATTN_SHAPES = ((64, 4, 1034, 1034, 4), (2, 3, 300, 130, 4), (1, 4, 1034, 1034, 4),
               (1, 4, 1034, 5000, 4))
# The backward likewise at B = 1 (1 query row a thread in its dq kernel)
# with ragged Lq and Lk, and at 4100 keys.
BWD_SHAPES = ((16, 4, 1034, 1034, 4), (2, 3, 300, 130, 4), (1, 4, 257, 1033, 4),
              (2, 4, 300, 4100, 4))
TRAIN_EPOCHS, TRAIN_BATCH = 2, 1024
# Phases 30-33: the linear-GCN family on a beauty-sized set. LightGCN at
# bench.py:248-251's config (the n_layers 2 combo of Model_YAML/LightGCN.yaml,
# dim 64, batch 1024), the others at their Model_YAML file's first combo.
LINEAR_DATASET = "beauty"
LIGHTGCN_CONFIG = dict(Model="LightGCN", n_layers=2, learning_rate=1e-3, reg_weight=1e-3,
                       batch_size=1024, dim_E=64)
LIGHTGCN_EPOCHS = 2
LINEAR_MODELS = ("BPR", "SimGCL", "XSimGCL", "NGCF", "LayerGCN")
OP_MODELS = ("LightGCN", "SimGCL", "XSimGCL")  # the builders make their operator
STEP_SHAPE = (2048, 1024)  # phase 32's seeded set, users x items
# Phase 32's bf16-operator step. The forward's products are of bf16 values,
# exact in float32, so card and CPU differ only in the order of the float32
# sums: the loss keeps STEP_LOSS_RTOL. Each table's gradient is the sum of
# two bdot gradients, each rounded to bf16 after float32 sums taken in
# another order, so either may land one bf16 ulp (2^-8 relative) away:
# 2^-6 of the tensor's largest entry, far below what a wrong row would move.
BF16_STEP_RTOL = 2.0 ** -6
# Phase 61's bf16 steps (LATTICE's dense bf16 item graph, MICRO's bf16 U-I
# inputs): the graph is rounded to bf16 from float32 sums taken in another
# order, so an entry may land one bf16 ulp away: the loss to 1e-4, as the CPU
# tests hold the bf16 paths to the JAX package's
BF16_LOSS_RTOL = 1e-4
# Phases 35-38: the models that need no kernel and no new trainer branch,
# each at its Model_YAML file's first combo on the beauty-sized set (with
# the synthetic 4096- and 384-wide features MCLN reads); phase 36 serves
# the exports of the stateful score model and of the -inf-masked one.
IDONLY_MODELS = ("MultVAE", "MacridVAE", "DualVAE", "DiffRec", "DHCF", "LightGODE", "SelfCF",
                 "FKAN_GCF", "MCLN")
IDONLY_SERVED = ("DualVAE", "DiffRec")
# DiffRec's served scores come from a reverse process whose products are of
# bf16 values; each is within this share of the largest score of the
# float32 process's (as tests/test_torch_diffrec.py holds it on the CPU).
P_SAMPLE_RTOL = 2.0 ** -6
# Phase 34: every model twice on one seed, at the path's shapes, for equal
# bits (the user-rows models one epoch, the others this many steps, then an
# evaluation)
# Phases 39-42: BSPM (training-free, TrainFreeTrainer), GFormer (GFormerTrainer,
# through K2) and the in-batch contrastive models HCCF, LightGCL, VGCL and
# GraphAug (the standard trainer), each at its Model_YAML file's first combo on
# the beauty-sized set. BSPM and GFormer are not exported: by the JAX CLI's
# rule their trainers keep no weights of their own.
FAMILY_MODELS = ("BSPM", "GFormer", "HCCF", "LightGCL", "VGCL", "GraphAug")
FAMILY_TRAINED = FAMILY_MODELS[1:]
FAMILY_EPOCHS = 1  # one epoch, to leave room in the run for phases 54-57
FAMILY_UNEXPORTED = ("BSPM", "GFormer")
GFORMER_TERMS = 3  # K2 terms a GFormer step (two self-contrasts, the cross term); k needs a gradient in each
# BSPM's scores, card against CPU on phase 32's seeded set: within this share
# of the largest score (each build's eigsh starts from the same vector, on
# the Gram of its own device)
BSPM_SCORE_TOL = 1e-4
# phases 43-47: AdaGCL's and Grade's multi-optimizer trainers, whose stacks
# run K4 over the doubled edge list, and four multimodal towers on the
# plain BPR branch (no kernel), all on the beauty-sized set with features
FAMILY2_MODELS = ("AdaGCL", "Grade")
FAMILY2_EPOCHS = 1  # likewise
FAMILY2_STEP_BATCHES = 2  # phase 46 holds the card to the CPU over this many batches
TOWER_MODELS = ("SLMRec", "VBPR", "BM3", "MGCL")
TOWER_EPOCHS = 1  # phases 45, 48 and 51, likewise
TOWER_SERVED = "MGCL"  # exported and served: its embeddings are a plain forward
# phases 48-50: the rest of the multimodal towers on the standard trainer (no
# kernel), on the beauty-sized set with features; DDRec on its stateful branch
TOWER2_MODELS = ("MMGCL", "LGMRec", "MMGCN", "MVGAE", "POWERec", "MENTOR", "DDRec")
TOWER2_SERVED = "DDRec"  # exported with its state and served
TOWER2_STATE_BATCHES = 2  # phase 49's DDRec steps: the second gated by the first's state
# phases 51-53: the towers on the host kNN graphs and the fixed-topology edge
# sums (no kernel), on the beauty-sized set with features
TOWER3_MODELS = ("MGCN", "SMORE", "GUME", "GRCN")
TOWER3_SERVED = "GRCN"  # exported and served: 192-wide embeddings without edge dropout
# phases 54-57: the user co-occurrence graph's towers and LightGT (no kernel),
# on the beauty-sized set with features; COHESION's embeddings and LightGT's
# rank lists exported and served
TOWER4_MODELS = ("DualGNN", "DRAGON", "COHESION", "LightGT")
TOWER4_SERVED = ("COHESION", "LightGT")
TOWER4_EPOCHS = 2  # LightGT's evaluation subsets redrawn before each pass
TOWER4_PHASE = {"DualGNN": "towers4", "DRAGON": "towers4", "COHESION": "cohesion",
                "LightGT": "lightgt"}
# phases 58-61: the rebuild-gated trainer branch (LATTICE, MICRO: batch 0 of
# each epoch builds the item graph, the later batches read it detached and
# step the gated params on a zero gradient) and MMSSL's adversarial trainer,
# on the beauty-sized set with features; LATTICE's and MICRO's exports served
REBUILD_MODELS = ("LATTICE", "MICRO")
MMSSL_MODEL = "MMSSL"
REBUILD_EPOCHS = 1
# K2 terms a MICRO step at bf16 (each modal view against h); k needs a gradient in each
MICRO_TERMS = 2
MMSSL_STEP_BATCHES = 2  # phase 61 holds MMSSL's two optimizer steps over this many batches
# phases 62-66: the diffusion family trainers' three-phase epochs (denoisers
# with fresh Adams, a rebuild without gradient, BPR batches on the rebuilt
# graph), on the beauty-sized set with features; neither exports
DIFFUSION_MODELS = ("DiffMM", "MHRec")
DIFFUSION_EPOCHS = 1
# K2 terms a phase-C step (DiffMM's two contrasts, MHRec's four); k needs a gradient in each
DIFFUSION_TERMS = {"DiffMM": 2, "MHRec": 4}
DIFFUSION_STEP_BATCHES = 2  # phase 66 holds each phase's optimizer steps over this many batches
# phase 46: a card optimizer step's params and moments against the float64
# Adam step of the CPU's state with the card's own gradient (rounding only)
ADAM_STEP_RTOL = 1e-5
DET_MODELS = ("CF_Diff", "FREEDOM", "SGL", "NCL", "DGCF", "DCCF", "MGAT", "BPR", "LightGCN",
              "SimGCL", "XSimGCL", "NGCF", "LayerGCN") + IDONLY_MODELS + FAMILY_TRAINED + (
              FAMILY2_MODELS + TOWER_MODELS + TOWER2_MODELS + TOWER3_MODELS + TOWER4_MODELS
              + REBUILD_MODELS + (MMSSL_MODEL,) + DIFFUSION_MODELS)
# the models phase 34 runs a whole epoch of: the user-rows models, and the
# diffusion family, whose epoch is its three phases
WHOLE_EPOCH_MODELS = ("CF_Diff", "DiffRec") + DIFFUSION_MODELS
DET_STEPS = 20


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed, after a warm-up on a side stream: the card's time,
    without the host's time to issue each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of the operations over the peak rate for their type and
    the bytes (each input read once, each output written once) over the
    memory rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_bound(shape, backward: bool = False):
    """Bound of fp32 attention at (B, H, Lq, Lk, dh): the forward's q.k and
    p.v take 2 dh flops each per score and move q, k, v and out; the
    backward's score recompute, dv, dp, dq and dk take 2 dh each and move
    q, k, v, out, dout, lse, dq, dk and dv. Dropout draws are not counted."""
    b, h, lq, lk, dh = shape
    scores, nq, nk = b * h * lq * lk, b * h * lq * dh, b * h * lk * dh
    if backward:
        return bound_ms(10 * dh * scores, 4 * (3 * nq + 2 * nk + b * h * lq + nq + 2 * nk))
    return bound_ms(4 * dh * scores, 4 * (2 * nq + 2 * nk))


def sdpa_ms(q, k, v):
    """(ms, output) of torch's scaled_dot_product_attention on the same
    inputs, in one call. A yardstick only: the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(q, k, v)
    return cuda_ms(lambda: sdpa(q, k, v), 5), out


def tol_share(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
              bf16_ulps: int = 0, where: bool = False):
    """Largest |got - want| / (atol + rtol |want| + ``bf16_ulps`` bf16 ulps
    of the larger of the two): at most 1 passes. With ``where``, also the
    flat index of that entry."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    share = ((got - want).abs() / (atol + rtol * want.abs() + bf16_ulps * ulp)).view(-1)
    at = int(share.argmax())
    return (share[at].item(), at) if where else share[at].item()


def row_adam_rows(gen, n: int, b: int, device) -> torch.Tensor:
    """``b`` raw int64 rows of an (n, .) table: rows 0-63 and the last 64
    (so every tile edge at their heights, and rows 0 and n-1), a few of
    them twice, and the rest uniform (duplicates by chance)."""
    if b == 1:
        return torch.tensor([n - 1], device=device)
    ends = torch.cat([torch.arange(64, device=device), torch.arange(n - 64, n, device=device)])
    dups = ends[::16]
    rest = torch.randint(0, n, (b - ends.numel() - dups.numel(),), generator=gen, device=device)
    return torch.cat([ends, dups, rest])[torch.randperm(b, generator=gen, device=device)]


def row_adam_phase(gen, device) -> dict:
    """fused_row_adam (through table_adam_update, as the trainer calls it)
    against row_adam_update, each of three steps from equal tables and
    moments, then its times at the main path's shapes.
    Returns per (table, "float32" or "bfloat16") {max_abs_err, ms,
    plain_ms, library_ms, bound_ms, bound_by}."""
    from chaorec_tpu_torch.ops.indexed_adam import (init_table_state, row_adam_update,
                                                    table_adam_update)
    from chaorec_tpu_torch.ops.row_adam import (fused_row_adam, prepare_sorted_rows,
                                                launch_grid, row_adam_reference)

    results = {}
    for name, (n, d) in ROW_ADAM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            p0 = torch.randn((n, d), generator=gen, device=device).to(dtype)
            kp, ks = p0.clone(), init_table_state(p0)
            pp, ps = p0.clone(), init_table_state(p0)
            worst, err = (0.0, ""), 0.0
            for step, b in enumerate((2048, 1, 2048), 1):
                rows = row_adam_rows(gen, n, b, device)
                g = torch.randn((b, d), generator=gen, device=device)
                count = torch.tensor(step, dtype=torch.int32, device=device)
                before = fused_row_adam.launches
                kp, ks = table_adam_update(kp, ks, rows, g, count, ROW_ADAM_LR)
                torch.cuda.synchronize()
                check(fused_row_adam.launches == before + 1, "table_adam_update did not launch")
                pp, ps = row_adam_update(pp, ps, rows, g, count, ROW_ADAM_LR)
                for t, got, want, tol in (("p", kp, pp, ROW_P_TOL), ("m", ks.m, ps.m, ROW_P_TOL),
                                          ("v", ks.v, ps.v, ROW_V_TOL)):
                    share, at = tol_share(got, want, **tol, bf16_ulps=int(dtype == torch.bfloat16),
                                          where=True)
                    if share > worst[0]:
                        worst = (share, f"{t} at step {step}, entry {at}: {got.view(-1)[at].item()!r}"
                                        f" vs {want.view(-1)[at].item()!r}")
                    err = max(err, (got.float() - want.float()).abs().max().item())
                    # each step starts from equal tables: a value rounded to the
                    # other neighbour would otherwise grow under cancellation
                    got.copy_(want)
            unit = " + 1 bf16 ulp" if dtype == torch.bfloat16 else ""
            say("kernel", f"fused_row_adam {name} ({n}, {d}) {str(dtype)[6:]}: 3 steps (B 2048, "
                f"1, 2048; duplicates, sentinels, rows 0..63 and N-64..N-1) vs row_adam_update: "
                f"max abs err {err:.3e}, worst entry at {worst[0]:.3f} of its tolerance (rtol "
                f"2e-5, atol 2e-7 for p and m, 1e-9 for v{unit}): {worst[1]}")
            check(worst[0] <= 1.0, f"fused_row_adam {name} {dtype} disagrees")
            results[name, str(dtype)[6:]] = dict(max_abs_err=err)
            del p0, kp, ks, pp, ps

        # times at the main path's shapes: one step's 2048 rows, fp32 and bf16
        for dtype in (torch.float32, torch.bfloat16):
            p = torch.randn((n, d), generator=gen, device=device).to(dtype)
            m = torch.rand((n, d), generator=gen, device=device).to(dtype) * 1e-3
            v = torch.rand((n, d), generator=gen, device=device).to(dtype) * 1e-6
            rows = row_adam_rows(gen, n, 2048, device)
            g = torch.randn((2048, d), generator=gen, device=device)
            count = torch.tensor(5, dtype=torch.int32, device=device)
            r_s, g_s = prepare_sorted_rows(rows, g, n)
            distinct = int((r_s < n).sum())
            tile, blocks, resident = launch_grid(p, m, v, g_s)
            ms = cuda_ms(lambda: fused_row_adam(p, m, v, r_s, g_s, count, ROW_ADAM_LR), 20)
            prep_ms = cuda_ms(lambda: prepare_sorted_rows(rows, g, n), 20)
            plain_ms = cuda_ms(lambda: row_adam_reference(p, m, v, r_s, g_s, count,
                                                          ROW_ADAM_LR), 5)
            size = p.element_size()
            bms, by = bound_ms(10 * n * d, 6 * n * d * size + distinct * d * 4 + 2048 * 4 + 4)
            # the same step by torch's own kernels: the dense gradient (in
            # the table's dtype), then a fused Adam (whose moments follow
            # the table's dtype), from the kernel's starting point
            lib_p = torch.nn.Parameter(p.clone())
            opt = torch.optim.Adam([lib_p], lr=ROW_ADAM_LR, fused=True)
            g_lib = g.to(dtype)

            def library():
                lib_p.grad = torch.zeros_like(lib_p).index_add_(0, rows, g_lib)
                opt.step()

            library()
            state = opt.state[lib_p]
            with torch.no_grad():
                lib_p.copy_(p)
                state["exp_avg"].copy_(m)
                state["exp_avg_sq"].copy_(v)
                state["step"].fill_(float(count) - 1)
                want = p.clone()
                fused_row_adam(want, m.clone(), v.clone(), r_s, g_s, count, ROW_ADAM_LR)
            library()
            lib_err = (lib_p.detach().float() - want.float()).abs().max().item()
            library_ms = cuda_ms(library, 10)
            results[name, str(dtype)[6:]].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                                 bound_ms=bms, bound_by=by, tile_rows=tile,
                                                 blocks=blocks)
            say("kernel", f"fused_row_adam {name} ({n}, {d}) {str(dtype)[6:]}, 2048 rows "
                f"({distinct} distinct), {tile} rows a block, {blocks} blocks ({resident} an SM at "
                f"once): kernel {ms:.4f} ms ({100 * bms / ms:.1f}% of its bound; + "
                f"prepare_sorted_rows {prep_ms:.4f} "
                f"ms), plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), library (zeros + "
                f"index_add_ + Adam(fused=True).step) {library_ms:.4f} ms, max abs diff from the "
                f"kernel {lib_err:.3e}")
            del lib_p, opt, state, want, g_lib
            del p, m, v, g, g_s
            torch.cuda.empty_cache()
    return results


def lse_inputs(gen, shape, device):
    """q (B, E) unit rows over the temperature and k (N, E) unit rows (with
    or without gradient), and a random weight g (B,) per row."""
    b, n, e, temp, k_grad = shape
    unit = [torch.nn.functional.normalize(torch.randn(rows, e, generator=gen, device=device), dim=1)
            for rows in (b, n)]
    q = (unit[0] / temp).requires_grad_()
    k = unit[1].requires_grad_(k_grad)
    return q, k, torch.randn(b, generator=gen, device=device)


def lse_counts():
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_lse_dk, streaming_lse_dq,
                                                     streaming_lse_fwd)

    return tuple(f.launches for f in (streaming_lse_fwd, streaming_lse_dq, streaming_lse_dk))


def kernel_wrappers():
    """Every kernel wrapper, in the order of KERNELS' sources."""
    from chaorec_tpu_torch.ops import kernel_wrappers as wrappers

    return wrappers()


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    for f in kernel_wrappers():
        f.launches = 0


def other_counts(*mine):
    """The launch counts of every wrapper but ``mine``."""
    return tuple(f.launches for f in kernel_wrappers() if f not in mine)


# the CSR gather-sums a ranking pass or an export makes (the segment
# graph's sums forward) of each model at its first combo, where its U-I
# graph is a segment graph: MICRO, MGCN and SMORE take one at every size,
# DualGNN (and LightGCN and SGL, two a layer) above dense_prop_threshold,
# at the catalogs. A training step makes each sum with its input's
# gradient: twice as many.
CSR_SUMS = {"DualGNN": 4, "MICRO": 4, "MGCN": 6, "SMORE": 7}


def csr_sums(model) -> int:
    """``model``'s CSR gather-sums a ranking pass, 0 where it holds no
    segment graph."""
    from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph

    graph = getattr(model, "graph", None)
    if not isinstance(graph, BipartiteGraph) or graph.use_dense:
        return 0
    return 2 * model.n_layers if model.name in ("LightGCN", "SGL") else CSR_SUMS[model.name]


def check_step_launches(phase: str, model, steps: int, *mine) -> int:
    """Checks the CSR gather-sum's launches since ``reset_counts``: those of
    ``steps`` training steps of ``model`` (``csr_sums`` twice a step), where
    nothing else launched it; and that no other kernel but ``mine``
    (counted by the caller) launched. Returns the launches."""
    from chaorec_tpu_torch.ops.csr_spmm import csr_spmm

    n, want = csr_spmm.launches, 2 * steps * csr_sums(model)
    others = other_counts(csr_spmm, *mine)
    say(phase, f"{model.name}'s {steps} steps: csr_spmm launches {n} (expected {want}: "
        f"{2 * csr_sums(model)} a step), other kernels {others} (expected none)")
    check(n == want and not any(others), f"{model.name}'s steps launched {n} and {others}")
    return n


def lse_bound(b, n, e, kernel):
    """Bound of one K2 kernel: the logits take 2 E flops each and dq/dk's
    product 2 E more (exps not counted); q and k are read once, lse and g
    (B,) once each by the backward, and the output written once."""
    flops = (2 if kernel == "fwd" else 4) * b * n * e
    nbytes = 4 * (b * e + n * e + {"fwd": b, "dq": 2 * b + b * e, "dk": 2 * b + n * e}[kernel])
    return bound_ms(flops, nbytes)


def ptxas_entries(name: str, fragment: str):
    """[(kernel, "Used N registers ...", "... spill stores, ... spill
    loads")] of ptxas's log for csrc/{name}.cu, for each compiled entry
    whose mangled name holds ``fragment``; [] when the library was built
    before this run (no log)."""
    from chaorec_tpu_torch import kernels

    out, entry, spill = [], None, ""
    for line in kernels.build(name).log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "registers" in line:
            if fragment in entry:
                out.append((entry, line.split(":", 1)[-1].strip(), spill))
            entry = None
    return out


def lse_timings(phase: str, label: str, q, k, g, k_grad: bool, sms: int) -> dict:
    """K2's forward, dq and (``k_grad``) dk kernels on q (B, E), k (N, E)
    and g (B,), each timed back to back beside the plain version, the
    library route (no single PyTorch call computes this: the product and
    torch.logsumexp, two calls, and autograd through them) and its bound;
    one line each. Returns {kernel: {kernel (the CUDA kernel that ran), ms,
    plain_ms, library_ms, bound_ms, bound_by}}."""
    from chaorec_tpu_torch.ops.streaming_lse import (forward_layout, streaming_logsumexp_reference,
                                                     streaming_lse_dk, streaming_lse_dq,
                                                     streaming_lse_fwd, takes_e64)

    (b, e), n = q.shape, k.shape[0]
    lse = streaming_lse_fwd(q, k)
    kq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
    plain = streaming_logsumexp_reference(kq, kk)
    lib = torch.logsumexp(torch.mm(kq, kk.T), dim=-1)
    e64 = takes_e64(q, k)
    fwd_kernel, splits, per = forward_layout(q, k, sms)
    row = {}
    for kernel, name, fn, plain_fn, lib_fn in (
            ("fwd", fwd_kernel, lambda: streaming_lse_fwd(q, k),
             lambda: streaming_logsumexp_reference(q, k),
             lambda: torch.logsumexp(torch.mm(q, k.T), dim=-1)),
            ("dq", "lse_bwd64_kernel<false>" if e64 else "lse_dq_kernel",
             lambda: streaming_lse_dq(q, k, lse, g),
             lambda: torch.autograd.grad(plain, (kq,), g, retain_graph=True),
             lambda: torch.autograd.grad(lib, (kq,), g, retain_graph=True)),
            ("dk", "lse_bwd64_kernel<true>" if e64 else "lse_dk_kernel",
             lambda: streaming_lse_dk(q, k, lse, g),
             lambda: torch.autograd.grad(plain, (kk,), g, retain_graph=True),
             lambda: torch.autograd.grad(lib, (kk,), g, retain_graph=True))):
        if kernel == "dk" and not k_grad:
            continue  # not on the path: NCL's prototypes need no gradient
        bms, by = lse_bound(b, n, e, kernel)
        row[kernel] = dict(kernel=name, ms=cuda_ms(fn, 20), plain_ms=cuda_ms(plain_fn, 10),
                           library_ms=cuda_ms(lib_fn, 10), bound_ms=bms, bound_by=by)
        grid = f", {splits} splits x {per} tiles" if kernel == "fwd" else ""
        say(phase, f"streaming_lse_{kernel} {label} ({b}, {n}, {e}) by {name}{grid}: kernel "
            f"{row[kernel]['ms']:.4f} ms, plain {row[kernel]['plain_ms']:.4f} ms, library "
            f"(torch.logsumexp(q @ k.T){'' if kernel == 'fwd' else ' and its autograd'}, two "
            f"calls) {row[kernel]['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{100 * bms / row[kernel]['ms']:.1f}% of it")
    return row


def lse_phase(gen, device) -> dict:
    """The streaming logsumexp kernels against the plain version and its
    autograd at every shape of LSE_SHAPES, then their times at SGL's two
    main shapes and NCL's prototypes (LSE_TIMED). Returns {"max_abs_err":
    {kernel: err}, side: {kernel: {kernel (the CUDA kernel that ran), ms,
    plain_ms, library_ms, bound_ms, bound_by}}}."""
    from chaorec_tpu_torch.ops.streaming_lse import FWD_BLOCKS_PER_SM, fwd64_blocks_per_sm

    errs = {"fwd": 0.0, "dq": 0.0, "dk": 0.0}
    for shape in LSE_SHAPES:
        lse_hold(gen, device, shape, errs)

    for frag, what in (("lse_fwd64_kernel", "forward"), ("lse_bwd64_kernel", "")):
        ptxas = ptxas_entries("streaming_lse", frag)
        for entry, regs, spill in ptxas:
            kind = what or ("dk" if "ILb1E" in entry else "dq")
            say("kernel", f"ptxas (csrc/streaming_lse.cu) {frag}, {kind}: {regs}; {spill}")
        if not ptxas:
            say("kernel", f"ptxas: no log for {frag} (built before this run)")
    say("kernel", f"lse_fwd64_kernel: {fwd64_blocks_per_sm()} blocks an SM (the occupancy "
        f"calculator; forward_splits assumes {FWD_BLOCKS_PER_SM})")
    results = {"max_abs_err": errs}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for side, shape in LSE_TIMED.items():
        q, k, g = lse_inputs(gen, shape, device)
        results[side] = lse_timings("kernel", side, q.detach(), k.detach(), g, shape[4], sms)
        del q, k, g
        torch.cuda.empty_cache()
    return results


def plain_in_slices(q, k, v, seed=None, keep=1.0, rows: int = 64):
    """mha_reference over the batch in slices (each with its groups' mask):
    the whole (4096, 4, 1034, 1034) score tensor of an export chunk would
    take 70 GB."""
    from chaorec_tpu_torch.ops.fused_attn import mha_reference

    h = q.shape[1]
    return torch.cat([mha_reference(q[s:s + rows], k[s:s + rows], v[s:s + rows], seed,
                                    keep, first_group=s * h)
                      for s in range(0, q.shape[0], rows)])


def plain_bwd_in_slices(q, k, v, dout, seed, keep, got, rows: int = 32):
    """Autograd's backward through mha_reference, slice by slice, held
    against the kernel's gradients ``got`` (dq, dk, dv) row for row.
    Returns (device ms of the backward alone, each slice's forward being
    outside the timed region; per gradient the max abs error; per gradient
    the largest plain entry)."""
    from chaorec_tpu_torch.ops.fused_attn import mha_reference

    h, total = q.shape[1], 0.0
    errs, scale = [0.0] * 3, [0.0] * 3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for s in range(0, q.shape[0], rows):
        leaves = [t[s:s + rows].detach().requires_grad_() for t in (q, k, v)]
        out = mha_reference(*leaves, seed, keep, first_group=s * h)
        start.record()
        want = torch.autograd.grad(out, leaves, dout[s:s + rows])
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
        for i, (a, w) in enumerate(zip(got, want)):
            errs[i] = max(errs[i], (a[s:s + rows] - w).abs().max().item())
            scale[i] = max(scale[i], w.abs().max().item())
    return total, errs, scale


@contextlib.contextmanager
def plain_attention():
    """CF_Diff's attention through mha_reference, with the kernel's seed and
    keep_prob, so the plain path draws the kernel's dropout mask. For the
    comparisons only."""
    from chaorec_tpu_torch.models import cf_diff
    from chaorec_tpu_torch.ops.fused_attn import mha_reference

    kernel = cf_diff.fused_mha
    cf_diff.fused_mha = mha_reference
    try:
        yield
    finally:
        cf_diff.fused_mha = kernel


def synthetic_dataset(name: str, seed: int, lens=(5, 14), features: bool = False,
                      shape=None):
    """``name``'s shape (or ``shape``, (users, items)) with ``lens`` (low,
    high) train items per user, drawn with a popularity skew (item weight ~
    1 / (rank + 10)), one val and one test item each; with ``features``,
    the loader's synthetic image and text features
    (``data/loading.synthetic_item_features``)."""
    from chaorec_tpu_torch.data.loading import (DATASET_STATS, T_FEAT_DIM, T_FEAT_SEED,
                                                V_FEAT_DIM, V_FEAT_SEED, RecDataset,
                                                _pad_lists, synthetic_item_features)

    num_user, num_item = shape or DATASET_STATS[name]
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(num_item) + 10.0)
    w = w[rng.permutation(num_item)]
    w /= w.sum()
    lens = rng.integers(*lens, num_user)
    hist = [rng.choice(num_item, size=int(n), replace=False, p=w) for n in lens]
    held = []
    for h in hist:
        seen = set(h.tolist())
        picks = []
        while len(picks) < 2:
            i = int(rng.integers(num_item))
            if i not in seen and i not in picks:
                picks.append(i)
        held.append(picks)
    edges = np.array([(u, i) for u, h in enumerate(hist) for i in h], np.int32)
    users = np.arange(num_user, dtype=np.int32)
    feats = {}
    if features:
        feats = dict(
            v_feat=synthetic_item_features(edges, num_user, num_item, V_FEAT_DIM, V_FEAT_SEED),
            t_feat=synthetic_item_features(edges, num_user, num_item, T_FEAT_DIM, T_FEAT_SEED))
    return RecDataset(
        name=name, num_user=num_user, num_item=num_item, train_edges=edges,
        history=_pad_lists([h.tolist() for h in hist], fill=num_item, sort=True),
        val_users=users, val_pos=_pad_lists([[p[0]] for p in held], fill=-1),
        test_users=users, test_pos=_pad_lists([[p[1]] for p in held], fill=-1),
        **feats,
    )


class RandomTables:
    """An embeddings-kind model whose params are its (user, item) tables."""

    name, rank_mode = "BPR", "embeddings"

    def embeddings(self, params):
        return params


class EpochProbe(logging.Filter):
    """Reads the trainer's own per-epoch log lines (the loss, then
    ``epoch_time_s``) as they are logged, and the device's peak memory
    since the previous epoch. A filter on the root logger, so it outlives
    the CLI's replacement of the handlers."""

    def __init__(self):
        super().__init__()
        self.epochs = []
        self._loss = None

    def filter(self, record):
        msg = record.getMessage()
        if m := re.match(r"Epoch (\d+), Loss: (\S+)$", msg):
            self._loss = float(m.group(2))
        elif m := re.match(r"epoch_time_s: total (\S+) \(train-dispatch (\S+) \| "
                           r"eval\+sync (\S+)\)", msg):
            self.epochs.append(dict(loss=self._loss, wall_s=float(m.group(1)),
                                    train_s=float(m.group(2)), eval_s=float(m.group(3)),
                                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
            torch.cuda.reset_peak_memory_stats()
        return True


def top_overlap(a: torch.Tensor, b: torch.Tensor, k: int) -> float:
    ia = torch.topk(a, k, dim=1).indices.cpu().numpy()
    ib = torch.topk(b, k, dim=1).indices.cpu().numpy()
    return float(np.mean([len(set(x) & set(y)) / k for x, y in zip(ia, ib)]))


def get_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.load(r)


def device_profile(phase: str, what: str, fn, out_path: str, groups=None):
    """Wall time of ``fn`` unprofiled, then device time by kernel and the
    idle share over one profiled call; with ``groups`` ({label: name
    fragments}), also the device time of the kernels whose lowercased name
    holds one of a group's fragments. Returns (wall ms, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        # device kernels only: an op's own row, or a range such as
        # Optimizer.step's annotation on the device, would count its kernels twice
        rows = sorted(((e.self_device_time_total, e.key, e.count) for e in events
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                       and not getattr(e, "is_user_annotation", False)),
                      reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        if busy_ms > 0:
            break
        # seen once in a long run: a profiled call whose trace held no kernel
        say(phase, f"{what}: the profiler saw no device kernel (try {attempt} of 3; "
            f"{len(events)} event kinds, {sum(e.device_type == DeviceType.CUDA for e in events)} "
            "on the device)")
    check(busy_ms > 0, "the profiler saw no device kernel")
    say(phase, f"{what}: wall {wall_ms:.1f} ms unprofiled, device kernels {busy_ms:.1f} ms, "
        f"idle share {100 * max(0.0, 1 - busy_ms / wall_ms):.1f}%")
    for us, key, count in rows[:10]:
        say(phase, f"{us / 1e3:9.2f} ms  {100 * us / 1e3 / busy_ms:5.1f}%  "
            f"x{count:<4d} {key[:90]}")
    for label, frags in (groups or {}).items():
        ms = sum(r[0] for r in rows if any(f in r[1].lower() for f in frags)) / 1e3
        say(phase, f"{label}: {ms:.2f} ms, {100 * ms / busy_ms:.1f}% of device time")
    with open(out_path, "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total", row_limit=40))
    return wall_ms, busy_ms


def check_artifact(path: str, ds, snapshot: str):
    """The ranklists artifact's shape, order and masking; returns its ids
    and each user's history as global ids."""
    with np.load(path) as z:
        rank_ids, rank_scores = z["rank_ids"], z["rank_scores"]
        check(str(z["snapshot"]) == snapshot, f"snapshot {z['snapshot']} != {snapshot}")
    check(rank_ids.shape == (ds.num_user, 200) and rank_scores.shape == rank_ids.shape,
          f"rank_ids shape {rank_ids.shape}")
    check(bool(np.isfinite(rank_scores).all()), "non-finite ranklist scores")
    check(bool((np.diff(rank_scores, axis=1) <= 0).all()), "ranklists not descending")
    check(bool(((rank_ids >= ds.num_user) & (rank_ids < ds.num_user + ds.num_item)).all()),
          "ranklist ids out of range")
    hist_global = np.where(ds.history.values < ds.num_item,
                           ds.history.values + ds.num_user, -1)
    seen_hits = sum(np.isin(rank_ids[u], hist_global[u]).sum() for u in range(ds.num_user))
    check(seen_hits == 0, f"{seen_hits} seen items in the ranklists")
    return rank_ids, hist_global


def check_serving(phase: str, path: str, ds, device, rank_ids, hist_global,
                  model_name: str = "CF_Diff") -> None:
    """HTTP answers of a ranklists artifact equal the artifact, hold no seen
    item, and 404 on an unknown path; request latency."""
    from chaorec_tpu_torch.serve import Recommender, serve_http

    rec = Recommender.load(path, device)
    srv = serve_http(rec, port=0, host="127.0.0.1")
    port = srv.server_address[1]
    try:
        health = get_json(port, "/healthz")
        check(health["ok"] and health["model"] == model_name, f"healthz: {health}")
        for users, k in (([0, 5, 17], 10), ([1, 2, 3, 100, 4095, 4096, ds.num_user - 1], 50)):
            resp = get_json(port, f"/recommend?user={','.join(map(str, users))}&k={k}")
            check(len(resp["results"]) == len(users), "wrong number of results")
            for u, res in zip(users, resp["results"]):
                got_ids = [it["item"] for it in res["items"]]
                check(res["user"] == u and got_ids == rank_ids[u, :k].tolist(),
                      f"user {u}: answer differs from the artifact")
                check(not set(got_ids) & set(hist_global[u].tolist()),
                      f"user {u}: a seen item was recommended")
        try:
            get_json(port, "/nowhere")
            check(False, "unknown path answered")
        except urllib.error.HTTPError as e:
            check(e.code == 404, f"unknown path gave {e.code}")
        lat = []
        for _ in range(50):
            t0 = time.perf_counter()
            get_json(port, "/recommend?user=0,5,17&k=10")
            lat.append((time.perf_counter() - t0) * 1e3)
        say(phase, f"http on 127.0.0.1:{port} ({health['snapshot']} {model_name} rank lists): "
            "healthz ok, "
            "2 recommend requests equal the artifact and hold no seen item, 404 on unknown "
            f"path; /recommend 3 users k=10 latency p50 {np.median(lat):.3f} ms, "
            f"p99 {np.percentile(lat, 99):.3f} ms over {len(lat)} requests")
    finally:
        srv.shutdown()
        srv.server_close()


class PreEpochTimer:
    """Times each ``pre_epoch`` of a model class while active, with the
    device synchronized at both ends, to split an epoch's training time."""

    def __init__(self, cls):
        self.cls, self.seconds = cls, []

    def __enter__(self):
        orig = self.orig = self.cls.pre_epoch

        def timed(model, params, epoch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(model, params, epoch)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)

        self.cls.pre_epoch = timed
        return self

    def __exit__(self, *exc):
        self.cls.pre_epoch = self.orig


@contextlib.contextmanager
def plain_table_update():
    """The trainer's table step through row_adam_update (the plain path)
    instead of the kernel. For the comparisons only."""
    from chaorec_tpu_torch.ops.indexed_adam import row_adam_update
    from chaorec_tpu_torch.train import loop

    kernel = loop.table_adam_update
    loop.table_adam_update = row_adam_update
    try:
        yield
    finally:
        loop.table_adam_update = kernel


def check_embeddings_serving(phase: str, path: str, ds, device, model_name: str) -> None:
    """An embeddings artifact of the best epoch: its tables' shapes, and HTTP
    answers that are the tables' own top-k (bf16 inputs summed in float64
    here), hold no seen item, and 404 on an unknown path; request latency."""
    from chaorec_tpu_torch.serve import Recommender, serve_http

    with np.load(path) as z:
        check(str(z["kind"]) == "embeddings" and str(z["model"]) == model_name
              and str(z["snapshot"]) == "best-epoch", f"artifact {z['kind']} {z['model']}")
        ue, ie = z["user_emb"], z["item_emb"]
    check(ue.shape[0] == ds.num_user and ie.shape[0] == ds.num_item
          and ue.shape[1] == ie.shape[1], f"tables {ue.shape} {ie.shape}")
    check(bool(np.isfinite(ue).all() and np.isfinite(ie).all()), "non-finite tables")
    ub = torch.from_numpy(ue).to(torch.bfloat16).double().numpy()
    ib = torch.from_numpy(ie).to(torch.bfloat16).double().numpy()
    rec = Recommender.load(path, device)
    srv = serve_http(rec, port=0, host="127.0.0.1")
    port = srv.server_address[1]
    try:
        health = get_json(port, "/healthz")
        check(health["ok"] and health["model"] == model_name, f"healthz: {health}")
        users = [u for u in (0, 5, 17, 100, 4095, 4096) if u < ds.num_user] + [ds.num_user - 1]
        k = 10
        resp = get_json(port, f"/recommend?user={','.join(map(str, users))}&k={k}")
        check(len(resp["results"]) == len(users), "wrong number of results")
        worst = 0.0
        for u, res in zip(users, resp["results"]):
            want = ub[u] @ ib.T
            seen = ds.history.values[u, :ds.history.lengths[u]]
            want[seen] = -np.inf
            got = [(it["item"] - ds.num_user, it["score"]) for it in res["items"]]
            check(res["user"] == u and len(got) == k, f"user {u}: malformed answer")
            check(not set(seen.tolist()) & {i for i, _ in got}, f"user {u}: a seen item")
            kth = np.sort(want)[-k]
            for i, score in got:
                worst = max(worst, abs(score - want[i]), kth - want[i])
        check(worst <= SCORE_TOL, f"answers are not the tables' top-{k}: off by {worst}")
        try:
            get_json(port, "/nowhere")
            check(False, "unknown path answered")
        except urllib.error.HTTPError as e:
            check(e.code == 404, f"unknown path gave {e.code}")
        lat = []
        for _ in range(50):
            t0 = time.perf_counter()
            get_json(port, "/recommend?user=0,5,17&k=10")
            lat.append((time.perf_counter() - t0) * 1e3)
        say(phase, f"http on 127.0.0.1:{port} ({health['snapshot']} {model_name} tables "
            f"{ue.shape}, {ie.shape}): {len(users)} users' top-{k} are the tables' own to "
            f"{worst:.2e} (bound {SCORE_TOL:g}), no seen item, 404 on unknown path; "
            f"/recommend 3 users k=10 latency p50 {np.median(lat):.3f} ms, "
            f"p99 {np.percentile(lat, 99):.3f} ms over {len(lat)} requests")
    finally:
        srv.shutdown()
        srv.server_close()


def sports_dataset(args):
    """The sports-sized set phases 10-18 share: ``--data_root``'s, or the
    synthetic one with the loader's synthetic features."""
    from chaorec_tpu_torch.data.loading import data_load

    t0 = time.perf_counter()
    fds = (data_load(FREEDOM_DATASET, args.data_root, has_v=True, has_t=True) if args.data_root
           else synthetic_dataset(FREEDOM_DATASET, args.seed, lens=(4, 8), features=True))
    say("freedom", f"{'data_load' if args.data_root else 'synthetic'} {FREEDOM_DATASET} "
        f"({fds.num_user}, {fds.num_item}), {fds.num_edges} train edges, v_feat "
        f"{fds.v_feat.shape}, t_feat {fds.t_feat.shape}: {time.perf_counter() - t0:.2f} s")
    return fds


def freedom_phases(args, device, fds):
    """Phases 10-13: FREEDOM's CLI run on sports, one step kernel vs plain
    path, the profiles and the bf16 leg. Returns the fused_row_adam
    launches of the CLI run and of the bf16 epoch."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.config import Config, grid_combinations, load_yaml_config
    from chaorec_tpu_torch.data.sampling import make_edge_batches, sample_negatives
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.models.freedom import FREEDOM
    from chaorec_tpu_torch.ops.mxu import bdot
    from chaorec_tpu_torch.ops.row_adam import fused_row_adam
    from chaorec_tpu_torch.train.loop import Trainer, deterministic_mode

    # 10. freedom: the CLI's grid run of FREEDOM on sports ------------------
    combo = next(grid_combinations(load_yaml_config("FREEDOM")))
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "freedom.npz")
        fcfg = Config(Model="FREEDOM", data_path=FREEDOM_DATASET, seed=args.seed,
                      num_epoch=FREEDOM_EPOCHS, log_dir=args.out_dir, export_artifact=art)
        probe = EpochProbe()
        logging.getLogger().addFilter(probe)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        try:
            with PreEpochTimer(FREEDOM) as pre:
                fbest = cli.run(fcfg, None, fds, device)  # reads Model_YAML/FREEDOM.yaml
                torch.cuda.synchronize()
        finally:
            logging.getLogger().removeFilter(probe)
        freedom_run_s = time.perf_counter() - t0
        freedom_launches = fused_row_adam.launches
        others = other_counts(fused_row_adam)
        n_fbatches = math.ceil(fds.num_edges / fcfg.batch_size)
        expected = FREEDOM_EPOCHS * n_fbatches * 2
        for e, (ep, pre_s) in enumerate(zip(probe.epochs, pre.seconds)):
            say("freedom", f"epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
                f"(pre_epoch {pre_s:.3f} s, training {ep['train_s'] - pre_s:.3f} s, eval "
                f"{ep['eval_s']:.3f} s), peak device memory {ep['peak_gib']:.2f} GiB")
        say("freedom", f"cli.run {combo}: {FREEDOM_EPOCHS} epochs x {n_fbatches} batches of "
            f"{fcfg.batch_size} + export: {freedom_run_s:.3f} s wall; fused_row_adam launches "
            f"{freedom_launches} (expected {expected} = {FREEDOM_EPOCHS} x {n_fbatches} x 2 "
            f"tables), other kernels {others} (expected none)")
        check(freedom_launches == expected and not any(others),
              f"FREEDOM launched {freedom_launches} and {others}")
        check(len(probe.epochs) == len(pre.seconds) == FREEDOM_EPOCHS,
              f"{len(probe.epochs)} epochs logged, {len(pre.seconds)} pre_epochs")
        check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
        check(sorted(fbest) == [5, 10, 20] and all(
            math.isfinite(v) for m in fbest.values() for v in m.values()), f"best {fbest}")
        say("freedom", "best test metrics: " + "; ".join(
            f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in fbest.items()))
        check_embeddings_serving("freedom", art, fds, device, "FREEDOM")
    torch.cuda.empty_cache()

    # 11. fstep: one FREEDOM step, kernel path against plain path -----------
    scfg = fcfg.replace(**combo, export_artifact="")
    fmodel = build_model(scfg, fds, device)
    trainer = Trainer(fmodel, fds, scfg)
    init = trainer.init_params()
    fmodel.pre_epoch(init, 0)
    fbatch = make_edge_batches(trainer.generator, trainer.edges, scfg.batch_size)[0]
    fbatch = dataclasses.replace(fbatch, neg_items=sample_negatives(
        trainer.generator, fbatch.users, trainer.history, fmodel.num_item, scfg.neg_candidates))
    tables = fmodel.table_params

    def freedom_step():
        params = {n: t.detach().clone() if n in tables else t.detach().clone().requires_grad_()
                  for n, t in init.items()}
        opt = trainer.make_optimizer(params)
        loss = trainer.train_step(params, opt, fbatch).item()
        return loss, params, trainer.table_state

    before = fused_row_adam.launches
    k_loss, k_params, k_state = freedom_step()
    check(fused_row_adam.launches == before + len(tables), "the kernel step did not launch")
    with plain_table_update():
        p_loss, p_params, p_state = freedom_step()
    check(fused_row_adam.launches == before + len(tables), "the plain step launched")
    worst = max((tol_share(k_params[n], p_params[n], **ROW_P_TOL), n) for n in p_params)
    for n in tables:
        worst = max(worst, (tol_share(k_state[n].m, p_state[n].m, **ROW_P_TOL), n + ".m"),
                    (tol_share(k_state[n].v, p_state[n].v, **ROW_V_TOL), n + ".v"))
    say("fstep", f"one FREEDOM step of {fbatch.users.shape[0]} edges, kernel vs plain table "
        f"update on the same batch and negatives: loss {k_loss:.7f} vs {p_loss:.7f}; worst "
        f"of params, tables and moments {worst[1]} at {worst[0]:.3f} of its tolerance")
    check(k_loss == p_loss and worst[0] <= 1.0, "FREEDOM step disagrees")
    del k_params, k_state, p_params, p_state

    # 12. profile: a FREEDOM step, a pre_epoch, and the row operators --------
    params = {n: t.detach().clone() if n in tables else t.detach().clone().requires_grad_()
              for n, t in init.items()}
    opt = trainer.make_optimizer(params)
    device_profile("profile", f"one FREEDOM training step of {scfg.batch_size} edges (forward, "
                   "backward, Adam, two row-sparse table updates)",
                   lambda: trainer.train_step(params, opt, fbatch),
                   os.path.join(args.out_dir, "chip_smoke_freedom_step_profile.txt"))
    device_profile("profile", "one FREEDOM pre_epoch (Gumbel top-k pruning, masked R, "
                   "R^T, R R^T, R^T R)",
                   deterministic_mode()(lambda: fmodel.pre_epoch(params, 1)),  # as the trainer
                   os.path.join(args.out_dir, "chip_smoke_freedom_pre_epoch_profile.txt"))
    r, rt = fmodel.masked_r, fmodel._rt
    nu, ni = r.shape
    rrt_ms = cuda_ms(lambda: bdot(r, rt), 3)
    rtr_ms = cuda_ms(lambda: bdot(rt, r), 3)
    rrt_bound = bound_ms(2 * nu * nu * ni, 2 * 2 * nu * ni + 4 * nu * nu, PEAK_BF16_FLOPS)
    rtr_bound = bound_ms(2 * ni * ni * nu, 2 * 2 * nu * ni + 4 * ni * ni, PEAK_BF16_FLOPS)
    say("profile", f"R R^T ({nu}x{ni} @ {ni}x{nu}, bf16 in, fp32 out): {rrt_ms:.3f} ms, bound "
        f"{rrt_bound[0]:.3f} ms ({rrt_bound[1]}); R^T R: {rtr_ms:.3f} ms, bound "
        f"{rtr_bound[0]:.3f} ms ({rtr_bound[1]})")
    # The same product with rows of whole 16-byte vectors (an item axis
    # padded with zero columns to a multiple of 8): a measurement for the
    # next step, not a path of the port.
    rp = torch.nn.functional.pad(r, (0, -ni % 8))
    rpt = rp.t().contiguous()
    say("profile", f"R R^T with the item axis padded to {rp.shape[1]} columns: "
        f"{cuda_ms(lambda: bdot(rp, rpt), 3):.3f} ms")
    del params, opt, init, trainer, r, rt, rp, rpt
    torch.cuda.empty_cache()

    # the bf16 leg (--relaxed_precision bf16): one epoch with the tables and
    # their moments stored in bf16, through the same kernel
    bcfg = scfg.replace(relaxed_precision="bf16", num_epoch=1)
    btrainer = Trainer(fmodel, fds, bcfg)
    before = fused_row_adam.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bbest = btrainer.run()
    torch.cuda.synchronize()
    bf16_s = time.perf_counter() - t0
    blaunches = fused_row_adam.launches - before
    say("bf16", f"one FREEDOM epoch with bf16 tables and moments: {bf16_s:.3f} s wall (pre_epoch, "
        f"training and eval), fused_row_adam launches {blaunches} (expected {n_fbatches * 2}), "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; test "
        f"recall@20 {bbest[20]['recall']:.5f}")
    check(blaunches == n_fbatches * 2, f"the bf16 epoch launched {blaunches}")
    check(all(btrainer.table_state[n].m.dtype == torch.bfloat16 for n in tables),
          "the bf16 leg's moments are not bf16")
    check(all(math.isfinite(v) for m in bbest.values() for v in m.values()), f"bf16 {bbest}")
    del fmodel, btrainer
    torch.cuda.empty_cache()
    return freedom_launches, blaunches


@contextlib.contextmanager
def plain_logsumexp():
    """catalog_logsumexp through streaming_logsumexp_reference (the plain
    path) instead of the kernels. For the comparisons only."""
    from chaorec_tpu_torch.ops import losses
    from chaorec_tpu_torch.ops.streaming_lse import streaming_logsumexp_reference

    kernel = losses.streaming_logsumexp
    losses.streaming_logsumexp = streaming_logsumexp_reference
    try:
        yield
    finally:
        losses.streaming_logsumexp = kernel


def first_combo(model_name: str):
    """(combo, one-combo grid) of Model_YAML/{model_name}.yaml's first combo."""
    from chaorec_tpu_torch.config import grid_combinations, load_yaml_config

    combo = next(grid_combinations(load_yaml_config(model_name)))
    grid = {k: [v] for k, v in combo.items()}
    grid["hyper_parameters"] = list(combo)
    return combo, grid


def ssl_phases(args, device, fds) -> dict:
    """Phases 14-19: SGL's and NCL's CLI runs on sports through the
    streaming logsumexp kernels, SGL's export and serving, one step of each
    kernel vs plain path, and each one's step profile. Returns each model's
    (fwd, dq, dk) launches of its CLI run."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.config import Config
    from chaorec_tpu_torch.data.sampling import make_edge_batches, sample_negatives
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_lse_dk, streaming_lse_dq,
                                                     streaming_lse_fwd)
    from chaorec_tpu_torch.train.loop import Trainer

    launches = {}
    for name, phase in (("SGL", "sgl"), ("NCL", "ncl")):
        # 14 / 17. the CLI's grid run, first combo ---------------------------
        combo, grid = first_combo(name)
        epochs = SSL_EPOCHS[name]
        with tempfile.TemporaryDirectory() as tmp:
            art = os.path.join(tmp, f"{name}.npz") if name == "SGL" else ""
            cfg = Config(Model=name, data_path=FREEDOM_DATASET, seed=args.seed, num_epoch=epochs,
                         log_dir=args.out_dir, export_artifact=art)
            probe = EpochProbe()
            logging.getLogger().addFilter(probe)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            try:
                best = cli.run(cfg, grid, fds, device)
                torch.cuda.synchronize()
            finally:
                logging.getLogger().removeFilter(probe)
            run_s = time.perf_counter() - t0
            launches[name] = lse_counts()
            others = other_counts(streaming_lse_fwd, streaming_lse_dq, streaming_lse_dk)
            n_batches = math.ceil(fds.num_edges / cfg.batch_size)
            terms, with_k_grad = SSL_TERMS[name]
            expected = tuple(epochs * n_batches * t for t in (terms, terms, with_k_grad))
            for e, ep in enumerate(probe.epochs):
                say(phase, f"epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
                    f"(training {ep['train_s']:.3f} s, eval {ep['eval_s']:.3f} s), peak device "
                    f"memory {ep['peak_gib']:.2f} GiB")
            say(phase, f"cli.run {combo}: {epochs} epochs x {n_batches} batches of "
                f"{cfg.batch_size}{' + export' if art else ''}: {run_s:.3f} s wall; "
                f"streaming_lse fwd/dq/dk launches {launches[name]} (expected {expected} = "
                f"{epochs} x {n_batches} x {terms} terms, {with_k_grad} of them with a k "
                f"gradient), other kernels {others} (expected none)")
            check(launches[name] == expected and not any(others),
                  f"{name} launched {launches[name]} and {others}")
            check(len(probe.epochs) == epochs, f"{len(probe.epochs)} epochs logged")
            check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
            check(sorted(best) == [5, 10, 20] and all(
                math.isfinite(v) for m in best.values() for v in m.values()), f"best {best}")
            say(phase, "best test metrics: " + "; ".join(
                f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in best.items()))
            if art:
                check_embeddings_serving(phase, art, fds, device, name)
        torch.cuda.empty_cache()

        # 15 / 18. one step, kernel path against plain path ------------------
        # On a float32 R: bdot's backward rounds each propagated gradient to
        # bf16 (as the JAX package's transpose does), so on the bf16 R an
        # fp32-level difference from the kernel can flip one bf16 ulp of a
        # large gradient entry, which is 4e-3 of it.
        step_phase = {"SGL": "sstep", "NCL": "nstep"}[name]
        scfg = cfg.replace(**combo, export_artifact="")

        def setup(graph_dtype):
            model = build_model(scfg.replace(graph_compute_dtype=graph_dtype), fds, device)
            trainer = Trainer(model, fds, scfg)
            init = trainer.init_params()
            batch = make_edge_batches(trainer.generator, trainer.edges, scfg.batch_size)[0]
            batch = dataclasses.replace(batch, neg_items=sample_negatives(
                trainer.generator, batch.users, trainer.history, model.num_item,
                scfg.neg_candidates))
            return model, trainer, init, batch

        model, trainer, init, batch = setup("float32")
        if name == "SGL":
            draws = model.view_masks(trainer.generator)
            loss_fn = model.loss_with_masks
        else:
            draws = model.prototypes(init, trainer.generator)
            loss_fn = model.loss_with_prototypes

        def one_step():
            leaves = {n: t.detach().clone().requires_grad_() for n, t in init.items()}
            loss = loss_fn(leaves, batch, draws)
            loss.backward()
            return loss.item(), {n: t.grad for n, t in leaves.items()}

        before = lse_counts()
        k_loss, k_grads = one_step()
        step_launches = tuple(a - b for a, b in zip(lse_counts(), before))
        check(step_launches == (terms, terms, with_k_grad),
              f"the kernel step launched {step_launches}")
        with plain_logsumexp():
            p_loss, p_grads = one_step()
        check(lse_counts() == tuple(b + d for b, d in zip(before, step_launches)),
              "the plain step launched")
        scale = max(g.abs().max().item() for g in p_grads.values())
        worst = max(((k_grads[n] - g).abs().max().item()
                     / (STEP_RTOL * g.abs().max().item() + STEP_ATOL * scale), n)
                    for n, g in p_grads.items())
        loss_rel = abs(k_loss - p_loss) / abs(p_loss)
        say(step_phase, f"one {name} step of {batch.users.shape[0]} edges on a float32 R, kernel "
            f"vs plain logsumexp on the same batch, negatives and "
            f"{'masks' if name == 'SGL' else 'prototypes'}: launches {step_launches}; loss "
            f"{k_loss:.7f} vs {p_loss:.7f} (rel {loss_rel:.2e}, "
            f"bound {STEP_LOSS_RTOL:g}); worst gradient {worst[1]} at {worst[0]:.3f} of its bound "
            f"(rtol {STEP_RTOL:g} of the tensor's max + {STEP_ATOL:g} of the gradient's max "
            f"{scale:.3e})")
        check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0, f"{name} step disagrees")
        del k_grads, p_grads, model, trainer, init, draws
        torch.cuda.empty_cache()

        # 16 / 19. profile: where one step's device time goes ----------------
        model, trainer, init, batch = setup(scfg.graph_compute_dtype)
        params = {n: t.detach().clone().requires_grad_() for n, t in init.items()}
        opt = trainer.make_optimizer(params)
        what = ("two edge-dropout views" if name == "SGL"
                else "k-means of both tables, 15 iterations each")
        device_profile(
            "profile", f"one {name} training step of {scfg.batch_size} edges (the dense bf16 "
            f"propagation of {max(model.n_layers, 2)} layers, {what}, {terms} streaming_lse "
            "terms, backward, Adam)",
            lambda: trainer.train_step(params, opt, batch),
            os.path.join(args.out_dir, f"chip_smoke_{name.lower()}_step_profile.txt"),
            groups={"K2 (streaming_lse kernels and their combine passes)": (
                        "lse_", "dq_combine"),
                    "GEMMs (the dense bf16 R propagation and its backward; k-means)": (
                        "gemm", "nvjet", "cutlass", "xmma"),
                    "bf16 -> fp32 copies (bdot's backward casts R)": ("copy",),
                    "gathers, scatters and bag sums (the views' hops, row gathers)": (
                        "index", "scatter", "gather", "embeddingbag"),
                    "reductions (argmax, norms, sums)": ("reduce_kernel",)})
        del params, opt, model, trainer, init
        torch.cuda.empty_cache()
    return launches


def scan_atol(exact: torch.Tensor, m: int, sequential: bool = False) -> float:
    """The prefix error model of chaorec_tpu/ops/ell.py:370-381: 4 ulp of
    the largest absolute prefix, times ceil(log2 M) (at least 1). With
    ``sequential``, plus ulp x sqrt(M): torch.cumsum along dim 0 on the card
    adds a column's rows one after another, so its error is a random walk
    of M roundings (the kernel's chains are a few hundred adds long)."""
    top = exact.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 23) if top > 0 else 0.0
    return ulp * (4 * max(1, math.ceil(math.log2(m))) + (math.sqrt(m) if sequential else 0))


def scan_shapes(fds) -> dict:
    """K4's (M, D) on the main paths over the sports-sized set: DGCF's
    factor chunks (dim_E / n_factors = 32) and DCCF's rows (dim_E 64) over
    the train edges, MGAT's conv widths (256 visual, 100 textual, then 64)
    over the doubled edges."""
    e = fds.num_edges
    return {"dgcf": (e, 32), "dccf": (e, 64), "mgat_v": (2 * e, 256), "mgat_t": (2 * e, 100),
            "mgat": (2 * e, 64)}


def k4_hold(phase: str, gen, device, shape, dtype=torch.float32, runs: int = 2) -> float:
    """K4 at ``shape`` against prefix_cumsum_reference and a float64 prefix
    under the gate (4 ulp of the largest prefix x ceil(log2 M); + ulp x
    sqrt(M) against the sequential plain version), the same bits in
    ``runs`` runs, one launch each. Returns the max abs error against the
    plain version."""
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum, prefix_cumsum_reference

    m = shape[0]
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    before = prefix_cumsum.launches
    got = prefix_cumsum(x)
    same = all(torch.equal(got, prefix_cumsum(x)) for _ in range(runs - 1))
    torch.cuda.synchronize()
    check(prefix_cumsum.launches == before + runs, f"prefix_cumsum {shape} did not launch")
    exact = torch.cumsum(x.double(), 0)
    plain = prefix_cumsum_reference(x)
    atol, plain_atol = scan_atol(exact, m), scan_atol(exact, m, sequential=True)
    err = (got.double() - exact).abs().max().item()
    err_plain = (got - plain).abs().max().item()
    plain_exact = (plain.double() - exact).abs().max().item()
    say(phase, f"prefix_cumsum {shape} {str(dtype)[6:]}: max abs err vs float64 {err:.3e} "
        f"(bound {atol:.3e} = 4 ulp of max |prefix| x ceil(log2 M)), vs plain "
        f"{err_plain:.3e} (bound {plain_atol:.3e}, + ulp x sqrt(M); plain vs float64 "
        f"{plain_exact:.3e}); {runs} runs bit-identical: {same}")
    check(got.dtype == torch.float32 and got.shape == x.shape, f"{shape}: {got.shape}")
    check(err <= atol and err_plain <= plain_atol and same, f"prefix_cumsum {shape} disagrees")
    return err_plain


def k4_times(phase: str, gen, device, name: str, m: int, d: int,
             dtype: torch.dtype = torch.float32) -> dict:
    """K4's time at (m, d) with ``dtype`` input: 20 calls back to back
    (``ms``) and in one CUDA graph (``graph_ms``), beside the plain
    version's, the library's (torch.cumsum to float32, one call) and the
    bound (the input's bytes and the float32 output's over the card's memory
    rate)."""
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum, prefix_cumsum_reference

    x = torch.randn((m, d), generator=gen, device=device).to(dtype)
    out = torch.empty(x.shape, dtype=torch.float32, device=device)
    nbytes = m * d * (x.element_size() + 4)
    bms, by = bound_ms(m * d, nbytes)
    r = dict(ms=cuda_ms(lambda: prefix_cumsum(x, out=out), 20),
             graph_ms=graph_ms(lambda: prefix_cumsum(x, out=out), 20),
             plain_ms=cuda_ms(lambda: prefix_cumsum_reference(x), 5),
             library_ms=cuda_ms(lambda: torch.cumsum(x, 0, dtype=torch.float32), 5),
             bound_ms=bms, bound_by=by)
    say(phase, f"prefix_cumsum ({m}, {d}) {str(dtype)[6:]} {name}: kernel {r['ms']:.4f} ms (20 "
        f"calls back to back; {r['graph_ms']:.4f} ms as a CUDA graph of 20 calls), plain "
        f"{r['plain_ms']:.4f} ms, library (torch.cumsum to float32) {r['library_ms']:.4f} ms, "
        f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB over 3.35 TB/s), "
        f"{100 * bms / r['ms']:.1f}% of it ({100 * bms / r['graph_ms']:.1f}% in the graph)")
    return r


def scan_phase(gen, device, fds) -> dict:
    """K4 against prefix_cumsum_reference and a float64 prefix at every
    path shape, the 1-D seg_sum's and small ragged ones, with identical
    bits on a second run (K4_BIT_RUNS at DGCF's shape); ptxas's registers
    and spills; its times at the path shapes; seg_sum (gather,
    K4, pointer difference) against an index_add_ segment sum at DGCF's
    and MGAT's shapes. Returns per path shape {max_abs_err, ms, graph_ms,
    plain_ms, library_ms, bound_ms, bound_by} and the seg_sum times."""
    from chaorec_tpu_torch import kernels
    from chaorec_tpu_torch.ops.ell import build_segment_transpose, seg_sum

    paths = scan_shapes(fds)
    e = fds.num_edges
    extra = {"1d": (e, None), "one_row": (1, 1), "ragged_7x3": (7, 3),
             "ragged_513x100": (513, 100), "two_tiles": (1300, 257)}
    results = {}
    for name, (m, d) in {**paths, **extra}.items():
        shape = (m,) if d is None else (m, d)
        for dtype in (torch.float32, torch.bfloat16) if name == "dgcf" else (torch.float32,):
            err_plain = k4_hold("k4", gen, device, shape, dtype,
                                K4_BIT_RUNS if name == "dgcf" else 2)
            if dtype == torch.float32:
                results[name] = dict(max_abs_err=err_plain)

    ptxas = [line.strip() for line in kernels.build("prefix_scan").log.splitlines()
             if "registers" in line or "spill" in line]
    for line in ptxas or ["no ptxas log: the library was built before this run"]:
        say("k4", f"ptxas (csrc/prefix_scan.cu): {line}")
    for name, (m, d) in paths.items():
        results[name].update(k4_times("k4", gen, device, name, m, d))

    # seg_sum as the models call it, against the atomics route, on the
    # segment ids of the path (DGCF's users over the train edges, MGAT's
    # destination nodes over the doubled edges); a printed yardstick only
    users = torch.from_numpy(fds.train_edges[:, 0]).to(device, torch.int64)
    items = torch.from_numpy(fds.train_edges[:, 1]).to(device, torch.int64) + fds.num_user
    dst = torch.cat([items, users])
    for name, idx, n_seg in (("dgcf", users, fds.num_user), ("mgat_v", dst, fds.num_user
                             + fds.num_item), ("mgat", dst, fds.num_user + fds.num_item)):
        m, d = paths[name]
        perm, ptr = build_segment_transpose(idx, n_seg)
        vals = torch.randn((m, d), generator=gen, device=device)
        ours = seg_sum(vals, idx, perm, ptr)
        theirs = torch.zeros((n_seg, d), device=device).index_add_(0, idx, vals)
        diff = (ours - theirs).abs().max().item()
        seg_ms = cuda_ms(lambda: seg_sum(vals, idx, perm, ptr), 20)
        add_ms = cuda_ms(lambda: torch.zeros((n_seg, d), device=device).index_add_(0, idx, vals), 20)
        results[name].update(seg_sum_ms=seg_ms, index_add_ms=add_ms)
        say("k4", f"segment sum of ({m}, {d}) into {n_seg} segments ({name}): seg_sum (permute "
            f"gather, K4, pointer difference) {seg_ms:.4f} ms, zeros + index_add_ {add_ms:.4f} "
            f"ms; max abs diff {diff:.3e}")
        del perm, ptr, vals, ours, theirs
    torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def plain_prefix_scan(float64: bool = False):
    """The segment sums' prefix through prefix_cumsum_reference (the plain
    path) instead of the kernel; with ``float64``, summed in float64 and
    rounded once. For the comparisons only."""
    from chaorec_tpu_torch.ops import ell
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum_reference

    def plain(v, out=None):
        ref = torch.cumsum(v.double(), 0).float() if float64 else prefix_cumsum_reference(v)
        return ref if out is None else out.copy_(ref)

    kernel = ell.prefix_cumsum
    ell.prefix_cumsum = plain
    try:
        yield
    finally:
        ell.prefix_cumsum = kernel


def scan_launches(cfg) -> tuple:
    """(K4 launches of one training step, of one forward without gradient)
    of ``cfg.Model`` under ``cfg``, read off the model's code: each seg_sum
    forward launches once, and each seg_gather whose input needs a gradient
    launches once in the backward. DGCF: 2 seg_sums and 2 seg_gathers per
    factor, iteration and layer. DCCF: per layer, 2 adaptive views of 1
    seg_sum and 3 seg_gathers. MGAT: per GAT round (3 a tower, 2 towers), 1
    seg_sum and 2 seg_gathers.

    AdaGCL, L layers (``alternating_step``): a propagation is a seg_gather
    and a seg_sum, so a stack whose input needs a gradient launches 2 L and
    one without (a generated view's encoder, under no_grad) L. Losses 1
    and 2: generator 1's view L, its stack 2 L, generator 2's stack 2 L
    (its gates under no_grad); loss 3: the main stack 2 L, generator 1's
    encoder 2 L, generator 2's loss L forward and, from its second layer
    on, 3 backward a layer (two gate gathers and the propagation's): 18 L -
    3. Grade, L layers (``grade_step``): loss_1 three views L each, three
    view stacks and two noise stacks 2 L each; bpr_reg 2 L; gen_loss three
    encoders L each (its gradient reaches the generators' heads only): 18
    L. Both evaluate with one stack: L."""
    if cfg.Model == "AdaGCL":
        return 18 * cfg.n_layers - 3, cfg.n_layers
    if cfg.Model == "Grade":
        return 18 * cfg.n_layers, cfg.n_layers
    if cfg.Model == "DGCF":
        sums = 2 * cfg.n_factors * cfg.n_iterations * cfg.n_layers
        return 2 * sums, sums
    if cfg.Model == "DCCF":
        return 8 * cfg.n_layers, 2 * cfg.n_layers
    if cfg.Model == "MGAT":
        return 18, 6
    raise ValueError(cfg.Model)


def seg_phases(args, device, fds) -> dict:
    """Phases 21-29: DGCF's, DCCF's and MGAT's CLI runs on sports through
    K4, DGCF's export and serving, one step of each kernel vs plain path,
    and each one's step profile. Returns each model's K4 launches of its
    CLI run."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.config import Config
    from chaorec_tpu_torch.data.sampling import make_edge_batches, sample_negatives
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum
    from chaorec_tpu_torch.train.loop import Trainer

    launches = {}
    for name in ("DGCF", "DCCF", "MGAT"):
        phase = name.lower()
        # 21 / 24 / 27. the CLI's grid run, first combo ---------------------
        combo, grid = first_combo(name)
        epochs = SEG_EPOCHS[name]
        with tempfile.TemporaryDirectory() as tmp:
            art = os.path.join(tmp, f"{name}.npz") if name == "DGCF" else ""
            cfg = Config(Model=name, data_path=FREEDOM_DATASET, seed=args.seed, num_epoch=epochs,
                         log_dir=args.out_dir, export_artifact=art)
            probe = EpochProbe()
            logging.getLogger().addFilter(probe)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            try:
                best = cli.run(cfg, grid, fds, device)
                torch.cuda.synchronize()
            finally:
                logging.getLogger().removeFilter(probe)
            run_s = time.perf_counter() - t0
            launches[name] = prefix_cumsum.launches
            others = other_counts(prefix_cumsum)
            n_batches = math.ceil(fds.num_edges / cfg.batch_size)
            per_step, per_eval = scan_launches(cfg.replace(**combo))
            expected = epochs * (n_batches * per_step + per_eval) + (per_eval if art else 0)
            for e, ep in enumerate(probe.epochs):
                say(phase, f"epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
                    f"(training {ep['train_s']:.3f} s, eval {ep['eval_s']:.3f} s), peak device "
                    f"memory {ep['peak_gib']:.2f} GiB")
            say(phase, f"cli.run {combo}: {epochs} epochs x {n_batches} batches of "
                f"{cfg.batch_size}{' + export' if art else ''}: {run_s:.3f} s wall; prefix_cumsum "
                f"launches {launches[name]} (expected {expected} = {epochs} x ({n_batches} x "
                f"{per_step} + {per_eval} eval){f' + {per_eval} export' if art else ''}), other "
                f"kernels {others} (expected none)")
            check(launches[name] == expected and not any(others),
                  f"{name} launched {launches[name]} and {others}")
            check(len(probe.epochs) == epochs, f"{len(probe.epochs)} epochs logged")
            check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
            check(sorted(best) == [5, 10, 20] and all(
                math.isfinite(v) for m in best.values() for v in m.values()), f"best {best}")
            say(phase, "best test metrics: " + "; ".join(
                f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in best.items()))
            if art:
                check_embeddings_serving(phase, art, fds, device, name)
        torch.cuda.empty_cache()

        # 22 / 25 / 28. one step, kernel path against plain path -------------
        # On a float32 R (DCCF's propagation; see the SGL step's note).
        step_phase = {"DGCF": "gstep", "DCCF": "cstep", "MGAT": "mstep"}[name]
        scfg = cfg.replace(**combo, export_artifact="")

        def setup(graph_dtype):
            model = build_model(scfg.replace(graph_compute_dtype=graph_dtype), fds, device)
            trainer = Trainer(model, fds, scfg)
            init = trainer.init_params()
            batch = make_edge_batches(trainer.generator, trainer.edges, scfg.batch_size)[0]
            batch = dataclasses.replace(batch, neg_items=sample_negatives(
                trainer.generator, batch.users, trainer.history, model.num_item,
                scfg.neg_candidates))
            return model, trainer, init, batch

        model, trainer, init, batch = setup("float32")
        state = None
        if model.stateful:  # routing scores away from the uniform start
            state = trainer.model_state + 0.5 * torch.randn(
                trainer.model_state.shape, generator=trainer.generator, device=device)

        def one_step():
            leaves = {n: t.detach().clone().requires_grad_() for n, t in init.items()}
            if state is None:
                loss, new_state = model.loss(leaves, batch, trainer.generator), None
            else:
                loss, new_state = model.loss_stateful(leaves, state, batch, trainer.generator)
            loss.backward()
            return loss.item(), {n: t.grad for n, t in leaves.items()}, new_state

        before = prefix_cumsum.launches
        kernel = one_step()
        check(prefix_cumsum.launches == before + per_step,
              f"the kernel step launched {prefix_cumsum.launches - before}, not {per_step}")
        with plain_prefix_scan():
            plain = one_step()
        with plain_prefix_scan(float64=True):
            exact = one_step()
        check(prefix_cumsum.launches == before + per_step, "the plain steps launched")

        def outputs(step):
            loss, grads, new_state = step
            return {"loss": torch.tensor(loss), **grads,
                    **({} if new_state is None else {"S": new_state})}

        k_out, p_out, e_out = (outputs(s) for s in (kernel, plain, exact))
        scale = max(g.abs().max().item() for n, g in p_out.items() if n not in ("loss", "S"))
        rows = []
        for n, want in p_out.items():
            base = (STEP_LOSS_RTOL * abs(want.item()) if n == "loss" else S_STEP_ATOL if n == "S"
                    else STEP_RTOL * want.abs().max().item() + STEP_ATOL * scale)
            diff = (k_out[n] - want).abs().max().item()
            spread = (want - e_out[n]).abs().max().item()
            rows.append((diff / max(base, SPREAD_FACTOR * spread), n, diff, base, spread))
        worst = max(rows)
        say(step_phase, f"one {name} step of {batch.users.shape[0]} edges on a float32 R, kernel "
            f"vs plain prefix sum on the same batch and negatives"
            f"{' and S' if state is not None else ''}: K4 launches {per_step}; loss "
            f"{kernel[0]:.7f} vs {plain[0]:.7f}; worst output {worst[1]} at {worst[0]:.3f} of its "
            f"bound (max abs diff {worst[2]:.3e}; the larger of {worst[3]:.3e} and "
            f"{SPREAD_FACTOR:g} x the plain path's spread from float64 prefixes {worst[4]:.3e})"
            + "".join(f"; {n} diff {d:.2e} spread {sp:.2e}" for _, n, d, _, sp in rows
                      if n in ("loss", "S")))
        check(worst[0] <= 1.0, f"{name} step disagrees")
        del kernel, plain, exact, k_out, p_out, e_out, model, trainer, init
        torch.cuda.empty_cache()

        # 23 / 26 / 29. profile: where one step's device time goes -----------
        model, trainer, init, batch = setup(scfg.graph_compute_dtype)
        params = {n: t.detach().clone().requires_grad_() for n, t in init.items()}
        opt = trainer.make_optimizer(params)
        torch.cuda.reset_peak_memory_stats()
        device_profile(
            "profile", f"one {name} training step of {scfg.batch_size} edges ({per_step} K4 "
            "launches, forward and backward, Adam)",
            lambda: trainer.train_step(params, opt, batch),
            os.path.join(args.out_dir, f"chip_smoke_{phase}_step_profile.txt"),
            groups={"K4 (prefix_scan: lookback_scan_kernel)": ("lookback_scan",),
                    "gathers, scatters and bag sums (seg_gather, permute gathers, pointer "
                    "differences, row gathers and their backward, softmax sums)": (
                        "index", "scatter", "gather", "embeddingbag"),
                    "GEMMs": ("gemm", "nvjet", "cutlass", "xmma"),
                    "reductions (norms, sums, softmax)": ("reduce_kernel", "softmax")})
        say("profile", f"{name} step peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del params, opt, model, trainer, init
        torch.cuda.empty_cache()
    return launches


class BuildProbe:
    """While active, records each model ``cli.run`` builds with its build's
    seconds and peak device memory above what was allocated before it
    (``builds``), and times each combined linear operator the builders make
    (the device synchronized at both ends) with its peak alike."""

    def __init__(self):
        self.models, self.ops, self.builds = [], [], []

    def __enter__(self):
        from chaorec_tpu_torch import cli
        from chaorec_tpu_torch.models import builders

        self.cli, self.builders = cli, builders
        build_model = self.build_model = cli.build_model
        build_op = self.build_op = builders.build_weighted_op

        def recorded(cfg, dataset, device):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = build_model(cfg, dataset, device)
            torch.cuda.synchronize()
            self.builds.append(dict(seconds=time.perf_counter() - t0, peak_gib=(
                torch.cuda.max_memory_allocated() - base) / 2 ** 30))
            self.models.append(model)
            return model

        def timed(dense_r, layer_weights, store_bf16=True):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            op = build_op(dense_r, layer_weights, store_bf16)
            torch.cuda.synchronize()
            self.ops.append(dict(op=op, seconds=time.perf_counter() - t0,
                                 layers=len(layer_weights) - 1,
                                 peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30))
            return op

        cli.build_model, builders.build_weighted_op = recorded, timed
        return self

    def __exit__(self, *exc):
        self.cli.build_model, self.builders.build_weighted_op = self.build_model, self.build_op


class ExportTimer:
    """While active, times each ``serve.export_artifact`` call (the device
    synchronized at both ends)."""

    def __enter__(self):
        from chaorec_tpu_torch import serve

        self.serve, self.orig, self.seconds = serve, serve.export_artifact, 0.0

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(*a, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out

        serve.export_artifact = timed
        return self

    def __exit__(self, *exc):
        self.serve.export_artifact = self.orig


def describe_op(built) -> str:
    op = built["op"]
    return (f"combined operator of {built['layers']} layers on {op.m_uu.device}, "
            f"{str(op.m_uu.dtype).replace('torch.', '')} blocks, {op.nbytes / 1e9:.3f} GB, "
            f"built in {built['seconds']:.3f} s, build peak {built['peak_gib']:.2f} GiB above "
            "what was allocated before it")


def linear_dataset(args):
    """The beauty-sized set phases 30-38 share: ``--data_root``'s, or a
    synthetic one, with the loader's synthetic image and text features
    (MCLN reads them; the edges are those of the set without them)."""
    from chaorec_tpu_torch.data.loading import data_load

    t0 = time.perf_counter()
    ds = (data_load(LINEAR_DATASET, args.data_root, has_v=True, has_t=True) if args.data_root
          else synthetic_dataset(LINEAR_DATASET, args.seed, features=True))
    say("lightgcn", f"{'data_load' if args.data_root else 'synthetic'} {LINEAR_DATASET} "
        f"({ds.num_user}, {ds.num_item}), {ds.num_edges} train edges: "
        f"{time.perf_counter() - t0:.2f} s")
    return ds


def linear_cli_run(phase, device, ds, name, cfg, grid, lse_terms: int = 0, k4_steps: int = 0):
    """One ``cli.run`` of a model on ``ds`` whose path reaches no kernel (the
    linear-GCN family's, the id-only models'), where no kernel launch is
    expected, or (``lse_terms``, MICRO's at bf16, the diffusion family's) K2,
    each of its forward, dq and dk ``lse_terms`` times a training step,
    (``k4_steps``, MHRec's) K4 that many times a training step, and (a
    model on a segment graph) the CSR gather-sum, ``csr_sums`` times a
    ranking pass or the export and twice that a training step; prints each
    epoch's loss, walls and peak memory, each operator's build and the
    export's wall. Returns (models, operators)."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.ops.csr_spmm import csr_spmm
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum

    probe = EpochProbe()
    logging.getLogger().addFilter(probe)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with BuildProbe() as built, ExportTimer() as export:
            best = cli.run(cfg, grid, ds, device)
            torch.cuda.synchronize()
    finally:
        logging.getLogger().removeFilter(probe)
    run_s = time.perf_counter() - t0
    k2, k4, n_csr = lse_counts(), prefix_cumsum.launches, csr_spmm.launches
    others = other_counts(*kernel_wrappers()[3:])  # K2, K4 and the CSR sum are checked apart
    for op in built.ops:
        say(phase, f"{name}: {describe_op(op)}")
    for e, ep in enumerate(probe.epochs):
        say(phase, f"{name} epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
            f"(training {ep['train_s']:.3f} s, eval {ep['eval_s']:.3f} s: "
            f"{ds.num_user / ep['eval_s']:.0f} users/s), peak device memory "
            f"{ep['peak_gib']:.2f} GiB")
    combo = {k: grid[k][0] for k in grid["hyper_parameters"]}
    user_rows = built.models[0].trainer_mode == "user_rows"
    n_batches = math.ceil((ds.num_user if user_rows else ds.num_edges) / cfg.batch_size)
    exported = f" + export {export.seconds:.3f} s" if cfg.export_artifact else ""
    expected = (cfg.num_epoch * n_batches * lse_terms,) * 3
    k4_expected = cfg.num_epoch * n_batches * k4_steps
    # a ranking pass each epoch, and the export's tables
    passes, sums = cfg.num_epoch + bool(cfg.export_artifact), csr_sums(built.models[0])
    csr_expected = (2 * cfg.num_epoch * n_batches + passes) * sums
    launched = (f"streaming_lse fwd/dq/dk launches {k2} (expected {expected}: {lse_terms} terms "
                f"a step), prefix_cumsum launches {k4} (expected {k4_expected}: {k4_steps} a "
                f"step), other kernels {others} (expected none)" if lse_terms or k4_steps else
                f"kernel launches {other_counts()} (expected none: no TPU kernel lies on this "
                "path)" if not sums else f"other kernels {others} (expected none)")
    if sums:
        launched += (f", csr_spmm launches {n_csr} (expected {csr_expected}: {2 * sums} a "
                     f"step, {sums} a ranking pass or export, {passes} of them)")
    say(phase, f"{name} cli.run {combo}: {cfg.num_epoch} epochs x {n_batches} batches of "
        f"{cfg.batch_size} {'users' if user_rows else 'edges'}{exported}: {run_s:.3f} s wall; "
        + launched)
    check(k2 == expected and k4 == k4_expected and n_csr == csr_expected and not any(others),
          f"{name} launched {k2}, {k4}, {n_csr} and {others}")
    check(len(probe.epochs) == cfg.num_epoch, f"{len(probe.epochs)} epochs logged")
    check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
    check(sorted(best) == [5, 10, 20] and all(
        math.isfinite(v) for m in best.values() for v in m.values()), f"best {best}")
    say(phase, f"{name} best test metrics: " + "; ".join(
        f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in best.items()))
    return built.models, built.ops


def step_loss(model):
    """(loss of (params, batch, draws), draw(generator)): each model's loss
    with its random draws given, so that two devices can share them."""
    if hasattr(model, "noise_draws"):  # SimGCL, XSimGCL
        return model.loss_with_noise, model.noise_draws
    if hasattr(model, "keep_mask"):  # NGCF
        return model.loss_with_keep, model.keep_mask
    return (lambda p, b, d: model.loss(p, b, None)), (lambda gen: None)


def linear_gcn_phases(args, device, ds) -> float:
    """Phases 30-33: LightGCN's CLI run on beauty with its export served,
    the other five models' runs, one step of each on the card against the
    CPU, and the six models' step profiles. Returns their wall seconds."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.params import clone_to
    from chaorec_tpu_torch.train.loop import Trainer

    t_start = time.perf_counter()
    # 30. lightgcn: the CLI's run at bench.py's LightGCN config -------------
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "lightgcn.npz")
        cfg, _ = path_config("LightGCN", args)
        cfg = cfg.replace(num_epoch=LIGHTGCN_EPOCHS, log_dir=args.out_dir, export_artifact=art)
        grid = {k: [LIGHTGCN_CONFIG[k]] for k in ("n_layers", "learning_rate", "reg_weight")}
        grid["hyper_parameters"] = list(grid)
        models, ops = linear_cli_run("lightgcn", device, ds, "LightGCN", cfg, grid)
        op = ops[0]["op"] if len(ops) == 1 else None
        check(len(models) == 1 and op is not None and models[0].linear_op is op
              and op.m_uu.dtype == torch.bfloat16 and op.m_uu.device.type == device.type,
              "LightGCN did not train on one bf16 combined operator on the card")
        check_embeddings_serving("lightgcn", art, ds, device, "LightGCN")
        del models, ops, op
    torch.cuda.empty_cache()

    # 31. linear: the other five, 1 epoch each at their first combo ---------
    for name in LINEAR_MODELS:
        cfg, _ = path_config(name, args)
        models, ops = linear_cli_run("linear", device, ds, name,
                                     cfg.replace(num_epoch=1, log_dir=args.out_dir),
                                     first_combo(name)[1])
        check(len(ops) == (1 if name in OP_MODELS else 0)
              and all(o["op"].m_uu.device.type == device.type for o in ops),
              f"{name} built {len(ops)} operators")
        del models, ops
        torch.cuda.empty_cache()

    # 32. lstep: one step of each on the card against the same on the CPU ---
    # On a float32 R, at a small set that the CPU's side of the check can
    # build and step quickly.
    sds = synthetic_dataset(LINEAR_DATASET, args.seed + 1, shape=STEP_SHAPE)
    cases = [(name, "float32") for name in ("LightGCN",) + LINEAR_MODELS]
    for name, r_dtype in cases + [("LightGCN", "bfloat16")]:
        cfg, _ = path_config(name, args)
        cfg = cfg.replace(graph_compute_dtype=r_dtype)
        cpu_model, card_model = build_model(cfg, sds, "cpu"), build_model(cfg, sds, device)
        if r_dtype == "bfloat16":
            check(all(m.linear_op is not None and m.linear_op.m_uu.dtype == torch.bfloat16
                      for m in (cpu_model, card_model)), "no bf16 operator for the step")
        trainer = Trainer(cpu_model, sds, cfg)
        params = trainer.init_params()
        batch = trainer.bpr_batch(make_edge_batches(trainer.generator, trainer.edges,
                                                    cfg.batch_size)[0])
        draws = step_loss(cpu_model)[1](trainer.generator)
        out = []  # (loss, gradients) on the CPU, then on the card
        for model in (cpu_model, card_model):
            model.pre_epoch(params, 0)  # LayerGCN's pruning: one host draw, the same in both
            leaves = {n: t.detach().to(model.device, copy=True).requires_grad_()
                      for n, t in params.items()}
            on = model.device
            loss = step_loss(model)[0](leaves, dataclasses.replace(
                batch, users=batch.users.to(on), weights=batch.weights.to(on),
                pos_items=batch.pos_items.to(on), neg_items=batch.neg_items.to(on)),
                clone_to(draws, on))
            loss.backward()
            out.append((loss.item(), {n: t.grad.cpu() for n, t in leaves.items()}))
        (c_loss, c_grads), (g_loss, g_grads) = out
        rtol = STEP_RTOL if r_dtype == "float32" else BF16_STEP_RTOL
        scale = max(g.abs().max().item() for g in c_grads.values())
        worst = max(((g_grads[n] - g).abs().max().item()
                     / (rtol * g.abs().max().item() + STEP_ATOL * scale), n)
                    for n, g in c_grads.items())
        loss_rel = abs(g_loss - c_loss) / abs(c_loss)
        given = {"SimGCL": ", noise", "XSimGCL": ", noise", "NGCF": ", keep mask",
                 "LayerGCN": ", pruned R"}.get(name, "")
        on_r = ("a float32 R" if r_dtype == "float32" else
                "its default bf16 operator, bdot's bf16 route on the card")
        say("lstep", f"one {name} step of {batch.users.shape[0]} edges on {on_r} "
            f"({sds.num_user} x {sds.num_item}, dim {cfg.dim_E}), card vs CPU on the same "
            f"params, batch, negatives{given}: loss {g_loss:.7f} vs {c_loss:.7f} (rel "
            f"{loss_rel:.2e}, bound {STEP_LOSS_RTOL:g}); worst gradient {worst[1]} at "
            f"{worst[0]:.3f} of its bound (rtol {rtol:g} of the tensor's max + "
            f"{STEP_ATOL:g} of the gradient's max {scale:.3e})")
        check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0, f"{name} card step disagrees")
        del cpu_model, card_model, trainer, out
    torch.cuda.empty_cache()

    # 33. profile: one step of each of the six at beauty, bf16 operator and R
    for name in ("LightGCN",) + LINEAR_MODELS:
        cfg, _ = path_config(name, args)
        model = build_model(cfg, ds, device)
        trainer = Trainer(model, ds, cfg)
        params = trainer.init_params()
        opt = trainer.make_optimizer(params)
        model.pre_epoch(params, 0)  # LayerGCN's pruned R
        batch = trainer.bpr_batch(make_edge_batches(trainer.generator, trainer.edges,
                                                    cfg.batch_size)[0])
        n = getattr(model, "n_layers", 0)
        what = {
            "LightGCN": "the operator's rows: one user gather, one gather of the positive and "
                        "negative items",
            "BPR": "the tables' rows, no propagation",
            "SimGCL": f"the operator's rows for BPR, two perturbed views of {n} layers on the "
                      "bf16 R, two in-batch InfoNCE terms",
            "XSimGCL": f"one perturbed forward of {n} layers on the bf16 R, its layer-1 view, two "
                       "in-batch InfoNCE terms; no operator in the loss",
            "NGCF": f"an edge-dropout mask, {n} hops through EdgeBags with self-loops and two "
                    "linear maps a layer",
            "LayerGCN": f"{n} layers of float32 products on the pruned R, cosine layer weights",
        }[name]
        torch.cuda.reset_peak_memory_stats()
        device_profile(
            "profile", f"one {name} training step of {cfg.batch_size} edges at {LINEAR_DATASET} "
            f"({what}, backward, Adam)",
            lambda: trainer.train_step(params, opt, batch),
            os.path.join(args.out_dir, f"chip_smoke_{name.lower()}_step_profile.txt"),
            groups={"index kernels (row and edge gathers, their scatters)": (
                        "index", "gather", "scatter"),
                    "GEMMs (products with the operator's rows or R, linear maps, backward)": (
                        "gemm", "nvjet", "cutlass", "xmma"),
                    "copy kernels (on a bf16 operator or R: bdot's backward's fp32 casts)": (
                        "copy",),
                    "reductions (norms, sums, logsumexp)": ("reduce_kernel", "logsumexp")})
        say("profile", f"{name} step peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del model, trainer, params, opt
        torch.cuda.empty_cache()
    return time.perf_counter() - t_start


def batch_to(batch, device):
    """A Batch with each of its tensors on ``device``."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).to(device) for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})


class Kinks:
    """The side of each ReLU kink a step takes, recorded on one step and
    held to on another.

    A ReLU's gradient jumps at 0, so two devices whose float32 roundings
    differ by an ulp can put a unit that lies within an ulp of 0 on
    opposite sides, and their gradients then differ by that unit's whole
    share, whatever their precision. ``record()`` notes, call by call, the
    mask ``x > 0`` of every ``F.relu`` and ``F.leaky_relu`` a step calls;
    ``replay()`` computes each such call as ``x`` times the recorded mask
    (the negative slope where it is 0), so that the second step takes the
    first one's side of every kink and differs from it only by rounding;
    ``compare()`` leaves the calls as they are. Under both, ``flips``
    counts the units whose own side differs from the recorded one."""

    def __init__(self):
        self.masks, self.flips, self._next = [], 0, 0

    @contextlib.contextmanager
    def _patched(self, mode):
        import torch.nn.functional as F

        relu, leaky = F.relu, F.leaky_relu
        self.flips, self._next = 0, 0

        def pinned(fn, x, slope, *args, **kwargs):
            side = (x > 0).detach()
            if mode == "record":
                self.masks.append(side)
                return fn(x, *args, **kwargs)
            mask = self.masks[self._next].to(x.device)
            self._next += 1
            self.flips += int((side != mask).sum())
            if mode == "compare":
                return fn(x, *args, **kwargs)
            return x * torch.where(mask, 1.0, slope).to(x.dtype)

        F.relu = lambda x, inplace=False: pinned(relu, x, 0.0)
        F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: pinned(
            leaky, x, negative_slope, negative_slope)
        if mode == "record":
            self.masks = []
        try:
            yield self
        finally:
            F.relu, F.leaky_relu = relu, leaky
        check(mode == "record" or self._next == len(self.masks),
              f"a step took {self._next} ReLU calls, its record {len(self.masks)}")

    def record(self):
        return self._patched("record")

    def replay(self):
        return self._patched("replay")

    def compare(self):
        return self._patched("compare")


def first_batch(trainer, cfg):
    """The first batch of an epoch as the trainer makes it: shuffled user
    rows, or shuffled edges completed by ``bpr_batch``."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches, make_epoch_batches

    if trainer.user_rows:
        return make_epoch_batches(trainer.generator, trainer.dataset.num_user,
                                  cfg.batch_size)[0]
    return trainer.bpr_batch(make_edge_batches(trainer.generator, trainer.edges,
                                               cfg.batch_size)[0])


def draws_step(model, params, state, batch, draws):
    """(loss, new state or None) of one step of an id-only model with its
    random draws given (``draws`` None: a model that draws nothing)."""
    if model.stateful:
        if draws is None:  # DDRec: its state is all it carries
            return model.loss_stateful(params, state, batch, None)
        return model.loss_stateful_with_draws(params, state, batch, draws)
    if hasattr(model, "loss_with_draws"):
        return model.loss_with_draws(params, batch, draws), None
    return model.loss(params, batch, None), None


def flat_state(state):
    """A model state as {name: float32 CPU tensor} (None stays None): a
    tensor, nested tuples of tensors (DiffRec's loss history and its counts,
    LATTICE's and MICRO's item graphs) or a dict (DualVAE's caches)."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        state = {"state": state}
    elif not isinstance(state, dict):
        state = {str(i): t for i, t in enumerate(leaves_of(state))}
    return {n: t.detach().float().cpu() for n, t in state.items()}


def leaves_of(tree):
    """The tensors of nested tuples (MICRO's two (vals, idx) graphs), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in leaves_of(x)]


def device_step(model, params, state, batch, draws, kinks, flat=True):
    """(loss, {leaf: gradient on the CPU}, new state as ``flat_state``, or
    as the model returns it on its device with ``flat`` False) of one step
    of an id-only model on its own device, from copies of ``params``,
    ``state``, ``batch`` and ``draws``, under the trainer's deterministic
    mode and ``kinks`` (a ``Kinks`` mode)."""
    from chaorec_tpu_torch.params import clone_to
    from chaorec_tpu_torch.train.loop import deterministic_mode

    on = model.device
    leaves = {n: t.detach().to(on, copy=True).requires_grad_() for n, t in params.items()}
    with deterministic_mode(), kinks:
        loss, new_state = draws_step(model, leaves, clone_to(state, on), batch_to(batch, on),
                                     clone_to(draws, on))
        loss.backward()
    grads = {n: (torch.zeros_like(t) if t.grad is None else t.grad).cpu()
             for n, t in leaves.items()}
    return loss.item(), grads, flat_state(new_state) if flat else new_state


def worst_share(got: dict, want: dict, rtol: float = STEP_RTOL):
    """(worst ratio of an entry's error to its bound, its name) over
    ``want``'s tensors: ``rtol`` of the tensor's largest entry plus
    STEP_ATOL of the largest entry of them all."""
    scale = max(w.abs().max().item() for w in want.values())
    return max(((got[n] - w).abs().max().item()
                / (rtol * w.abs().max().item() + STEP_ATOL * scale), n)
               for n, w in want.items())


def idonly_phases(args, device, ds) -> float:
    """Phases 35-38: the nine id-only models' CLI runs on beauty (DualVAE's
    and DiffRec's exports served), one step of each on the card against the
    CPU, and each one's step profile; no kernel launch expected anywhere.
    Returns their wall seconds."""
    from chaorec_tpu_torch.eval.ranking import mask_rows, scorer
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.train.loop import Trainer, deterministic_mode

    t_start = time.perf_counter()
    # 35. idonly: cli.run of each, one epoch at its first combo --------------
    # 36. idserve: DualVAE's and DiffRec's exports of that epoch, served
    with tempfile.TemporaryDirectory() as tmp:
        for name in IDONLY_MODELS:
            cfg, _ = path_config(name, args)
            art = os.path.join(tmp, f"{name}.npz") if name in IDONLY_SERVED else ""
            models, _ = linear_cli_run("idonly", device, ds, name,
                                       cfg.replace(num_epoch=1, log_dir=args.out_dir,
                                                   export_artifact=art),
                                       first_combo(name)[1])
            model = models[0]
            check(model.device.type == device.type and not model.table_params,
                  f"{name} is not on the card")
            if art:
                reset_counts()
                rank_ids, hist_global = check_artifact(art, ds, "best-epoch")
                check_serving("idserve", art, ds, device, rank_ids, hist_global, name)
                # the masking rule on the card, over the whole catalog: seen
                # items are each user's last (at -inf: DiffRec) whatever the
                # unseen items score
                gen = torch.Generator(device).manual_seed(args.seed)
                params = model.init_params(gen)
                state = model.init_state(device, gen)
                ids = torch.arange(64, device=device)
                hist = torch.from_numpy(ds.history.values[:64]).to(device)
                with deterministic_mode():
                    scores = scorer(model, params, state)(ids)
                    masked = mask_rows(scores, hist, float(model.mask_value))
                    order = torch.topk(masked, model.num_item, dim=1).indices.cpu().numpy()
                seen_at = mask_rows(torch.zeros_like(scores), hist, 1.0).bool()
                check(bool((masked[seen_at] == float(model.mask_value)).all()),
                      f"{name}: a seen item is not at the mask value")
                for u in range(64):
                    n = int(ds.history.lengths[u])
                    seen = set(ds.history.values[u, :n].tolist())
                    check(set(order[u, model.num_item - n:].tolist()) == seen,
                          f"{name} user {u}: seen items not ranked last")
                how = ("score_users_stateful over the trainer's carried caches"
                       if hasattr(model, "score_users_stateful") else "score_users")
                extra = ""
                if name == "DiffRec":
                    check(model.sample_dtype == torch.bfloat16
                          and model.mask_value == float("-inf"),
                          "DiffRec did not rank by a bf16 p_sample with -inf masking")
                    model.sample_dtype = None
                    with deterministic_mode():
                        f32 = model.score_users(params, ids)
                    model.sample_dtype = torch.bfloat16
                    rel = ((scores - f32).abs().max() / f32.abs().max()).item()
                    extra = (f"; the bf16 p_sample against the float32 one: max abs diff "
                             f"{rel:.2e} of the largest score (bound {P_SAMPLE_RTOL:g}), top-50 "
                             f"agreement {top_overlap(scores, f32, 50):.4f}")
                    check(rel <= P_SAMPLE_RTOL,
                          f"DiffRec's bf16 p_sample is {rel:.2e} of the largest score away "
                          f"from the float32 one")
                others = other_counts()
                say("idserve", f"{name}: ranked by {how}, seen items masked with "
                    f"{float(model.mask_value):g} and last over all {model.num_item} items for "
                    f"64 users on the card{extra}; kernel launches {others} (expected none)")
                check(not any(others), f"{name} serving launched {others}")
                del params, state, scores, masked
            del models, model
            torch.cuda.empty_cache()

    # 37. idstep: one step of each on the card against the same on the CPU --
    # (the card's held to the CPU's side of every ReLU kink, see Kinks), and
    # the card's again with TF32 products allowed: the control, which
    # MCLN's must fail
    sds = synthetic_dataset(LINEAR_DATASET, args.seed + 1, shape=STEP_SHAPE, features=True)
    for name in IDONLY_MODELS:
        cfg, _ = path_config(name, args)
        cfg = cfg.replace(graph_compute_dtype="float32")
        cpu_model, card_model = build_model(cfg, sds, "cpu"), build_model(cfg, sds, device)
        if name == "DHCF":  # each device's generator draws its own frozen W
            card_model.load_frozen_weights(cpu_model.frozen_w)
        trainer = Trainer(cpu_model, sds, cfg)
        params, state = trainer.init_params(), trainer.model_state
        batch = first_batch(trainer, cfg)
        draws = (cpu_model.draws(trainer.generator, batch, state)
                 if hasattr(cpu_model, "draws") else None)
        kinks = Kinks()
        c_loss, c_grads, c_state = device_step(cpu_model, params, state, batch, draws,
                                               kinks.record())
        reset_counts()
        g_loss, g_grads, g_state = device_step(card_model, params, state, batch, draws,
                                               kinks.replay())
        others, flips = other_counts(), kinks.flips
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _, t_grads, _ = device_step(card_model, params, state, batch, draws, kinks.replay())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        worst, control = worst_share(g_grads, c_grads), worst_share(t_grads, c_grads)
        loss_rel = abs(g_loss - c_loss) / abs(c_loss)
        state_msg, state_ok = "", True
        if c_state is not None:
            s_worst = worst_share(g_state, c_state)
            state_ok = s_worst[0] <= 1.0
            state_msg = f"; new state: worst {s_worst[1]} at {s_worst[0]:.3f} of the same bound"
        given = {"MultVAE": "dropout mask, eps", "MacridVAE": "dropout mask, Gumbel uniforms, eps",
                 "DualVAE": "eps, caches", "DiffRec": "timesteps, noise, dropout mask",
                 "SelfCF": "rate, edge uniforms, target masks", "MCLN": "interest items",
                 "DHCF": "frozen W"}.get(name, "")
        say("idstep", f"one {name} step of {batch.users.shape[0]} "
            f"{'users' if trainer.user_rows else 'edges'} on a float32 R ({sds.num_user} x "
            f"{sds.num_item}, dim {cfg.dim_E}), card vs CPU on the same params, batch"
            f"{', ' + given if given else ''}, ReLU sides: loss {g_loss:.7f} vs {c_loss:.7f} "
            f"(rel {loss_rel:.2e}, bound {STEP_LOSS_RTOL:g}); worst gradient {worst[1]} at "
            f"{worst[0]:.3f} of its bound (rtol {STEP_RTOL:g} of the tensor's max + "
            f"{STEP_ATOL:g} of the gradient's max){state_msg}; ReLU units the card put on the "
            f"other side {flips}; with TF32 products (the control) worst {control[1]} at "
            f"{control[0]:.3f}; kernel launches {others}")
        check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0 and state_ok and not any(others),
              f"{name} card step disagrees")
        check(name != "MCLN" or control[0] > 1.0,
              f"{name}: the gate did not see TF32 products (control at {control[0]:.3f})")
        del cpu_model, card_model, trainer
    torch.cuda.empty_cache()

    # 38. idprofile: one step of each at beauty under the profiler -----------
    groups = {"GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90"),
              "index kernels (gathers, their scatters, index_copy)": ("index", "gather",
                                                                      "scatter"),
              "reductions (norms, sums, softmax, logsumexp)": ("reduce_kernel", "softmax",
                                                               "logsumexp"),
              "elementwise": ("elementwise",)}
    for name in IDONLY_MODELS:
        cfg, _ = path_config(name, args)
        model = build_model(cfg, ds, device)
        trainer = Trainer(model, ds, cfg)
        params = trainer.init_params()
        opt = trainer.make_optimizer(params)
        batch = first_batch(trainer, cfg)
        rows = "users" if trainer.user_rows else "edges"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        device_profile("idprofile", f"one {name} training step of {cfg.batch_size} {rows} at "
                       f"{LINEAR_DATASET} (forward, backward, Adam)",
                       lambda: trainer.train_step(params, opt, batch),
                       os.path.join(args.out_dir, f"chip_smoke_{name.lower()}_step_profile.txt"),
                       groups=groups)
        others = other_counts()
        say("idprofile", f"{name} step peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; kernel launches {others}")
        check(not any(others), f"{name} step launched {others}")
        del model, trainer, params, opt
        torch.cuda.empty_cache()
    return time.perf_counter() - t_start


def path_config(name: str, args):
    """(Config, dataset name) of ``name`` as this script's CLI runs train
    it: CF_Diff at MODEL_CONFIG on the baby-sized set, LightGCN at
    LIGHTGCN_CONFIG and the rest of its family at their Model_YAML file's
    first combo on the beauty-sized set, and so the id-only models and
    phases 39-57's, every other model at its first combo on the
    sports-sized set."""
    from chaorec_tpu_torch.config import Config

    if name == "CF_Diff":
        return Config(data_path=DATASET, seed=args.seed, batch_size=TRAIN_BATCH,
                      **MODEL_CONFIG), DATASET
    if name == "LightGCN":
        return Config(data_path=LINEAR_DATASET, seed=args.seed, **LIGHTGCN_CONFIG), LINEAR_DATASET
    ds = (LINEAR_DATASET if name in (LINEAR_MODELS + IDONLY_MODELS + FAMILY_MODELS
                                     + FAMILY2_MODELS + TOWER_MODELS + TOWER2_MODELS
                                     + TOWER3_MODELS + TOWER4_MODELS + REBUILD_MODELS
                                     + (MMSSL_MODEL,) + DIFFUSION_MODELS)
          else FREEDOM_DATASET)
    return Config(Model=name, data_path=ds, seed=args.seed).replace(**first_combo(name)[0]), ds


def seeded_run(cfg, ds, device, steps=None):
    """(losses, rank list, seconds) of a fresh trainer (the model's
    ``trainer_cls``, or ``Trainer``) on ``cfg``'s seed: pre_epoch, then one
    whole epoch (``steps`` None) or its first ``steps`` batches (completed
    by ``Trainer.bpr_batch``: negatives, and MCLN's interest items; GFormer
    resamples its graphs every ``fix_steps`` of them, as its trainer does),
    then ``evaluate``; all under the trainer's deterministic mode."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.train import loop

    t0 = time.perf_counter()
    model = build_model(cfg, ds, device)
    family = getattr(model, "trainer_cls", loop.Trainer)(model, ds, cfg)
    trainer = getattr(family, "_base", family)
    params = trainer.init_params()
    opt = trainer.make_optimizer(params)
    with loop.deterministic_mode():
        model.pre_epoch(params, 0)
        if steps is None:
            losses = [trainer.train_epoch(params, opt)]
        else:
            batches = make_edge_batches(trainer.generator, trainer.edges, cfg.batch_size)
            losses = []
            for i, batch in enumerate(batches[:steps]):
                if hasattr(family, "sample_graphs"):
                    if i % model.fix_steps == 0:
                        graphs = family.sample_graphs(params)
                    loss = family.train_step(params, opt, trainer.bpr_batch(batch), graphs)
                elif family is not trainer:  # AdaGCL's, Grade's: every optimizer a batch
                    loss = family.train_step(params, opt, trainer.bpr_batch(batch))
                else:
                    loss = trainer.train_step(params, opt, trainer.bpr_batch(batch))
                losses.append(loss.detach())
            losses = torch.stack(losses).cpu().numpy()
        rank = trainer.evaluate(params)[2].cpu().numpy()
    torch.cuda.synchronize()
    return np.asarray(losses, np.float32), rank, time.perf_counter() - t0


def determinism_phase(args, device, datasets) -> dict:
    """Phase 34: each model twice from a fresh Trainer on one seed at the
    path's shapes (the user-rows models and the diffusion family one epoch,
    the others DET_STEPS steps), then an evaluation: the losses' bits and the rank lists must be
    equal. One JSON line per model; returns {model: that line}."""
    out = {}
    for name in DET_MODELS:
        cfg, ds_name = path_config(name, args)
        steps = None if name in WHOLE_EPOCH_MODELS else DET_STEPS
        (l1, r1, s1), (l2, r2, s2) = (seeded_run(cfg, datasets[ds_name], device, steps)
                                      for _ in range(2))
        line = {"determinism": name, "steps": "1 epoch" if steps is None else steps,
                "equal_loss_bits": bool(np.array_equal(l1.view(np.int32), l2.view(np.int32))),
                "equal_rank_lists": bool(np.array_equal(r1, r2)),
                "finite": bool(np.isfinite(l1).all()), "seconds": [round(s1, 3), round(s2, 3)]}
        print(json.dumps(line), flush=True)
        check(line["equal_loss_bits"] and line["equal_rank_lists"] and line["finite"],
              f"{name}: two runs on one seed differ: {line}")
        out[name] = line
        torch.cuda.empty_cache()
    return out


class Cuts:
    """The side of each clip bound (``torch.clamp``), hard cut
    (``models/graphaug.hard_cut``, the generated views' 0.5 cut
    ``models/adagcl.kept_edges``, DDRec's similarity cut
    ``models/ddrec.kept_by_sim``), k-means assignment
    (``ops/kmeans._assign``), POWERec's weakest modality
    (``models/powerec.weakest``), MENTOR's and GUME's noise signs
    (``models/mentor.signs``, ``models/gume.signs``), GUME's absolute gaps
    (``models/gume.gap``) and GRCN's strongest modality
    (``models/grcn.modal_max``) a step takes, recorded on one step and held
    to on another, as ``Kinks`` holds the ReLUs.

    GraphAug's view weights jump from 0 to above 0.2 at the cut, VGCL's
    contrast moves a row to another cluster when two centroids are within an
    ulp of tying, and a clipped value's gradient vanishes at its bound: two
    devices whose float32 roundings differ by an ulp can take the two sides.
    ``record()`` notes each call's sides (-1 below the lower bound, 1 above
    the upper, else 0; the cut's kept entries; the assignment);
    ``replay()`` computes each call from the recorded sides, so that the
    second step takes the first one's; ``flips`` counts the entries whose
    own side differs from the recorded one."""

    def __init__(self):
        self.sides, self.flips, self._next = [], 0, 0

    @contextlib.contextmanager
    def _patched(self, mode):
        from chaorec_tpu_torch.models import (adagcl, ddrec, grade, graphaug, grcn, gume, mentor,
                                              powerec)
        from chaorec_tpu_torch.ops import kmeans

        clamp, cut, assign = torch.clamp, graphaug.hard_cut, kmeans._assign
        kept, by_sim, weakest, signs = (adagcl.kept_edges, ddrec.kept_by_sim, powerec.weakest,
                                        mentor.signs)
        g_signs, g_gap, modal_max = gume.signs, gume.gap, grcn.modal_max
        self.flips, self._next = 0, 0
        if mode == "record":
            self.sides = []

        def pinned(side, recompute, replayed):
            side = side.detach()
            if mode == "record":
                self.sides.append(side)
                return recompute()
            rec = self.sides[self._next].to(side.device)
            self._next += 1
            self.flips += int((side != rec).sum())
            return recompute() if mode == "compare" else replayed(rec)

        def pinned_clamp(x, min=None, max=None):
            side = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
            if min is not None:
                side = torch.where(x < min, -1, side).to(torch.int8)
            if max is not None:
                side = torch.where(x > max, 1, side).to(torch.int8)
            return pinned(side, lambda: clamp(x, min, max),
                          lambda rec: torch.where(rec == -1, min if min is not None else x,
                                                  torch.where(rec == 1, max if max is not None
                                                              else x, x)))

        torch.clamp = pinned_clamp
        graphaug.hard_cut = lambda x, t: pinned(x > t, lambda: cut(x, t),
                                                lambda rec: x * rec.to(x.dtype))
        kmeans._assign = lambda x, c: pinned(assign(x, c), lambda: assign(x, c),
                                             lambda rec: rec)
        adagcl.kept_edges = grade.kept_edges = lambda p: pinned(
            p >= 0.5, lambda: kept(p), lambda rec: rec.to(p.dtype))
        ddrec.kept_by_sim = lambda sim, th: pinned(sim >= th, lambda: by_sim(sim, th),
                                                   lambda rec: rec.to(torch.float32))
        powerec.weakest = lambda x: pinned(weakest(x), lambda: weakest(x), lambda rec: rec)
        mentor.signs = lambda x: pinned(signs(x), lambda: signs(x), lambda rec: rec)
        gume.signs = lambda x: pinned(g_signs(x), lambda: g_signs(x), lambda rec: rec)
        gume.gap = lambda a, b: pinned(torch.sign(a - b), lambda: g_gap(a, b),
                                       lambda rec: (a - b) * rec)
        grcn.modal_max = lambda x: pinned(torch.argmax(x, 1), lambda: modal_max(x),
                                          lambda rec: x.gather(1, rec[:, None])[:, 0])
        try:
            yield self
        finally:
            torch.clamp, graphaug.hard_cut, kmeans._assign = clamp, cut, assign
            adagcl.kept_edges = grade.kept_edges = kept
            ddrec.kept_by_sim, powerec.weakest, mentor.signs = by_sim, weakest, signs
            gume.signs, gume.gap, grcn.modal_max = g_signs, g_gap, modal_max
        check(mode == "record" or self._next == len(self.sides),
              f"a step made {self._next} pinned calls, its record {len(self.sides)}")

    def record(self):
        return self._patched("record")

    def replay(self):
        return self._patched("replay")


@contextlib.contextmanager
def pinned_sides(*modes):
    """Each of ``modes`` (a ``Kinks`` or ``Cuts`` mode) entered at once."""
    with contextlib.ExitStack() as stack:
        for m in modes:
            stack.enter_context(m)
        yield


class TrainFreeTimer:
    """While active, times each ``TrainFreeTrainer.run`` (BSPM's one
    evaluation pass; the device synchronized at both ends)."""

    def __enter__(self):
        from chaorec_tpu_torch.models import bspm

        self.cls, self.orig, self.seconds = bspm.TrainFreeTrainer, bspm.TrainFreeTrainer.run, []

        def timed(trainer):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(trainer)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        self.cls.run = timed
        return self

    def __exit__(self, *exc):
        self.cls.run = self.orig


def family_cli_run(device, ds, name, cfg, grid) -> tuple:
    """Phase 39's ``cli.run`` of one model on ``ds``: each epoch's loss,
    walls, eval users per second and peak memory (BSPM: its spectral build
    and its one evaluation pass); GFormer's K2 launches against
    ``GFORMER_TERMS`` a step, none anywhere else; BSPM's and GFormer's
    export skipped with the JAX CLI's warning and no file. Returns (the
    model, K2's (fwd, dq, dk) launches)."""
    from chaorec_tpu_torch import cli

    probe = EpochProbe()
    logging.getLogger().addFilter(probe)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with BuildProbe() as built, TrainFreeTimer() as evals:
            best = cli.run(cfg, grid, ds, device)
            torch.cuda.synchronize()
    finally:
        logging.getLogger().removeFilter(probe)
    run_s = time.perf_counter() - t0
    k2 = lse_counts()
    others = other_counts(*kernel_wrappers()[3:6])
    model = built.models[0]
    check(len(built.models) == 1 and model.device.type == device.type,
          f"{name} is not on the card")
    combo = {k: grid[k][0] for k in grid["hyper_parameters"]}
    n_batches = math.ceil(ds.num_edges / cfg.batch_size)
    if name == "BSPM":
        from chaorec_tpu_torch.models.bspm import TrainFreeTrainer

        eval_s = evals.seconds[0]
        again = TrainFreeTrainer(model, ds, cfg)._inner  # the same pass once more, warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        again.evaluate({})
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t1
        from chaorec_tpu_torch.models.bspm import EIGSH_MAX_ITEMS

        solver = ("eigsh on the host" if model.num_item <= EIGSH_MAX_ITEMS
                  else "the randomized SVD of R on the card")
        say("family", f"BSPM: spectral build (C = R^T R on the card, {solver}, k = "
            f"{model.b.shape[1]}) {model.build_seconds:.3f} s; one evaluation pass "
            f"{eval_s:.3f} s ({ds.num_user / eval_s:.0f} users/s, {model.k_s} Euler steps), "
            f"again {warm_s:.3f} s ({ds.num_user / warm_s:.0f} users/s); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check(len(evals.seconds) == 1 and not probe.epochs, "BSPM did not make one pass")
        expected = (0, 0, 0)
    else:
        for e, ep in enumerate(probe.epochs):
            say("family", f"{name} epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
                f"(training {ep['train_s']:.3f} s, eval {ep['eval_s']:.3f} s: "
                f"{ds.num_user / ep['eval_s']:.0f} users/s), peak device memory "
                f"{ep['peak_gib']:.2f} GiB")
        check(len(probe.epochs) == cfg.num_epoch, f"{len(probe.epochs)} epochs logged")
        check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
        terms = GFORMER_TERMS if name == "GFormer" else 0
        expected = (cfg.num_epoch * n_batches * terms,) * 3
    say("family", f"{name} cli.run {combo}: {cfg.num_epoch if name != 'BSPM' else 0} epochs x "
        f"{n_batches} batches of {cfg.batch_size} edges: {run_s:.3f} s wall; streaming_lse "
        f"fwd/dq/dk launches {k2} (expected {expected}), other kernels {others} (expected "
        f"none)")
    check(k2 == expected and not any(others), f"{name} launched {k2} and {others}")
    check(sorted(best) == [5, 10, 20] and all(
        math.isfinite(v) for m in best.values() for v in m.values()), f"best {best}")
    say("family", f"{name} best test metrics: " + "; ".join(
        f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in best.items()))
    if name in FAMILY_UNEXPORTED:
        check_export_skipped("family", name, cfg)
    return model, k2


def gformer_lse_phase(gen, device, ds) -> dict:
    """K2 at GFormer's three shapes on ``ds`` (the user and the item
    self-contrast, whose q are rows of k's own table, and the users against
    the item table): the forward, and the gradients of the tables through
    autograd (dq and dk summed into one table where q and k share it),
    against the plain version under the gates of phase 3; then each
    kernel's time beside the plain version's, the library route's and its
    bound. Returns {"max_abs_err": {kernel: err}, side: {kernel: timing}}."""
    from chaorec_tpu_torch.ops.losses import catalog_logsumexp
    from chaorec_tpu_torch.ops.streaming_lse import streaming_logsumexp_reference

    b, e = 1024, 64
    sides = {"user": (ds.num_user, "self"), "item": (ds.num_item, "self"),
             "cross": (ds.num_item, "cross")}
    errs = {"fwd": 0.0, "dq": 0.0, "dk": 0.0}
    results = {"max_abs_err": errs}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for side, (n, kind) in sides.items():
        # rows of N(0, 1/8) entries: logits of about unit spread, a row
        # against itself about 8, as a trained table's
        table = (torch.randn(n, e, generator=gen, device=device) / math.sqrt(8)).requires_grad_()
        users = (torch.randn(ds.num_user, e, generator=gen, device=device)
                 / math.sqrt(8)).requires_grad_()
        rows = torch.randint(0, n if kind == "self" else ds.num_user, (b,), generator=gen,
                             device=device)
        g = torch.randn(b, generator=gen, device=device)
        leaves = (table,) if kind == "self" else (users, table)

        def run(fn):
            q = table[rows] if kind == "self" else users[rows]
            out = fn(q, table)
            return out, torch.autograd.grad(out, leaves, g)

        before = lse_counts()
        got, grads = run(catalog_logsumexp)
        torch.cuda.synchronize()
        launched = tuple(a - c for a, c in zip(lse_counts(), before))
        want, wgrads = run(streaming_logsumexp_reference)
        share = tol_share(got, want, **LSE_TOL)
        errs["fwd"] = max(errs["fwd"], (got - want).abs().max().item())
        rels = []
        for name, a, w in zip(("dq", "dk") if kind == "cross" else ("dq+dk",), grads, wgrads):
            err = (a - w).abs().max().item()
            for k in ("dq", "dk"):
                if k in name:
                    errs[k] = max(errs[k], err)
            rels.append((name, err / w.abs().max().item()))
        say("k2gf", f"catalog_logsumexp {side} ({b}, {n}, {e}), q {'rows of k' if kind == 'self' else 'user rows, k the item table'}: launches fwd/dq/dk "
            f"{launched}; fwd max abs err {(got - want).abs().max().item():.3e} ({share:.3f} of "
            f"rtol/atol 1e-5); " + ", ".join(f"{nm} max abs err / max |plain| {r:.2e}"
                                             for nm, r in rels)
            + f" (bound {LSE_BWD_REL_TOL:g})")
        check(launched == (1, 1, 1) and share <= 1.0
              and max(r for _, r in rels) <= LSE_BWD_REL_TOL, f"K2 at GFormer's {side} disagrees")

        # times, kernel by kernel, on these inputs
        q = (table[rows] if kind == "self" else users[rows]).detach()
        results[side] = lse_timings("k2gf", f"gformer {side}", q, table.detach(), g, True, sms)
        del table, users, q, got, grads, want, wgrads
        torch.cuda.empty_cache()
    return results


def family_phases(args, device, ds) -> tuple:
    """Phases 39-42: the six models' CLI runs on beauty (BSPM one pass,
    the others FAMILY_EPOCHS epochs; GFormer through K2), K2 at GFormer's
    shapes, one step of each trained model on the card against the CPU and
    BSPM's scores likewise, BSPM's bits over two builds, and each one's
    step profile. Returns (their wall seconds, GFormer's K2 launches, K2's
    results at its shapes)."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches
    from chaorec_tpu_torch.eval.ranking import rank_from_scores
    from chaorec_tpu_torch.models import bspm, build_model
    from chaorec_tpu_torch.models.gformer import graphs_from_arrays
    from chaorec_tpu_torch.params import clone_to
    from chaorec_tpu_torch.train.loop import Trainer, deterministic_mode

    t_start = time.perf_counter()
    # 39. family: cli.run of each at its first combo ----------------------
    gformer_launches = None
    with tempfile.TemporaryDirectory() as tmp:
        for name in FAMILY_MODELS:
            cfg, _ = path_config(name, args)
            art = os.path.join(tmp, f"{name}.npz") if name in FAMILY_UNEXPORTED else ""
            model, k2 = family_cli_run(device, ds, name, cfg.replace(
                num_epoch=FAMILY_EPOCHS, log_dir=args.out_dir, export_artifact=art),
                first_combo(name)[1])
            if name == "GFormer":
                gformer_launches = k2
                n_batches = math.ceil(ds.num_edges / cfg.batch_size)
                say("family", f"GFormer: K2 launches an epoch {n_batches * GFORMER_TERMS} of "
                    f"each kernel ({n_batches} steps x {GFORMER_TERMS} terms), host resamples an "
                    f"epoch {math.ceil(n_batches / model.fix_steps)}")
            del model
            torch.cuda.empty_cache()

    # 40. k2gf: K2 at GFormer's three shapes, held and timed ---------------
    lse = gformer_lse_phase(torch.Generator(device=device).manual_seed(args.seed + 40),
                            device, ds)

    # 41. famstep: one step of each on the card against the CPU's ----------
    # on phase 32's seeded 2048 x 1024 set, float32 R, equal params, batch
    # and draws, the card held to the CPU's side of each kink (Kinks, Cuts)
    sds = synthetic_dataset(LINEAR_DATASET, args.seed + 1, shape=STEP_SHAPE)
    for name in FAMILY_TRAINED:
        cfg, _ = path_config(name, args)
        cfg = cfg.replace(graph_compute_dtype="float32")
        cpu_model, card_model = build_model(cfg, sds, "cpu"), build_model(cfg, sds, device)
        if name == "LightGCL":  # each device's generator draws its own SVD sketch
            for f in ("u_mul_s", "v_mul_s", "ut", "vt"):
                setattr(card_model, f, getattr(cpu_model, f).to(device))
        family = getattr(cpu_model, "trainer_cls", Trainer)(cpu_model, sds, cfg)
        trainer = getattr(family, "_base", family)
        params = trainer.init_params()
        if name != "GFormer":
            batch = first_batch(trainer, cfg)
            draws = (cpu_model.draws(trainer.generator, batch)
                     if hasattr(cpu_model, "draws") else None)
            kinks, cuts = Kinks(), Cuts()
            c_loss, c_grads, _ = device_step(cpu_model, params, None, batch, draws,
                                             pinned_sides(kinks.record(), cuts.record()))
            reset_counts()
            g_loss, g_grads, _ = device_step(card_model, params, None, batch, draws,
                                             pinned_sides(kinks.replay(), cuts.replay()))
            worst, loss_rel, others = worst_share(g_grads, c_grads), abs(g_loss - c_loss) / abs(
                c_loss), other_counts()
            given = {"HCCF": "", "LightGCL": ", SVD factors", "VGCL": ", noise, k-means initial rows",
                     "GraphAug": ", dropout masks, gate and RelaxedBernoulli uniforms, random "
                                 "edges"}[name]
            say("famstep", f"one {name} step of {batch.users.shape[0]} edges on a float32 R "
                f"({sds.num_user} x {sds.num_item}, dim {cfg.dim_E}), card vs CPU on the same "
                f"params, batch, negatives{given}: loss {g_loss:.7f} vs {c_loss:.7f} (rel "
                f"{loss_rel:.2e}, bound {STEP_LOSS_RTOL:g}); worst gradient {worst[1]} at "
                f"{worst[0]:.3f} of its bound; ReLU units on the other side {kinks.flips}, "
                f"clip, cut and k-means entries {cuts.flips}; kernel launches {others}")
            check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0 and not any(others),
                  f"{name} card step disagrees")
        else:
            # one group: the CPU's sampled graphs on both devices, each step
            # from the CPU trajectory's params, after which the CPU steps on
            opt = trainer.make_optimizer(params)
            arrays = family.sample_arrays(params)
            n = cpu_model.num_nodes
            graphs = {"cpu": graphs_from_arrays(arrays, n, "cpu"),
                      "card": graphs_from_arrays(arrays, n, device)}
            from chaorec_tpu_torch.models.gformer import EdgeList

            cand = EdgeList.build(cpu_model.base_rows_np, cpu_model.base_cols_np, n, "cpu",
                                  trained=False)
            card_cand = EdgeList.build(cpu_model.base_rows_np, cpu_model.base_cols_np, n, device,
                                       trained=False)
            c_att = cpu_model.sampler_att(params, cand)
            g_att = card_model.sampler_att(clone_to(params, device), card_cand).cpu()
            att_err = ((g_att - c_att).abs().max() / c_att.abs().max()).item()
            check(att_err <= STEP_RTOL, f"GFormer's sampler attention: {att_err:.2e}")
            batches = make_edge_batches(trainer.generator, trainer.edges, cfg.batch_size)
            worst_all, loss_all, flips, launched = (0.0, ""), 0.0, 0, (0, 0, 0)
            for batch in batches[:cpu_model.fix_steps]:
                batch = trainer.bpr_batch(batch)
                out = []
                cuts = Cuts()
                for model, on, mode in ((cpu_model, "cpu", cuts.record),
                                        (card_model, device, cuts.replay)):
                    leaves = {k: v.detach().to(on, copy=True).requires_grad_()
                              for k, v in params.items()}
                    before = lse_counts()
                    with deterministic_mode(), mode():
                        loss = model.loss_graphs(leaves, batch_to(batch, on),
                                                 graphs["cpu" if on == "cpu" else "card"])
                        loss.backward()
                    if on != "cpu":
                        launched = tuple(a + c - d for a, c, d in
                                         zip(launched, lse_counts(), before))
                    out.append((loss.item(), {k: (torch.zeros_like(v) if v.grad is None
                                                  else v.grad).cpu() for k, v in leaves.items()}))
                (c_loss, c_grads), (g_loss, g_grads) = out
                w = worst_share(g_grads, c_grads)
                worst_all = max(worst_all, w)
                loss_all = max(loss_all, abs(g_loss - c_loss) / abs(c_loss))
                flips += cuts.flips
                with deterministic_mode():
                    family.train_step(params, opt, batch, graphs["cpu"])
            steps = min(cpu_model.fix_steps, len(batches))
            say("famstep", f"GFormer, one group of {steps} steps of {cfg.batch_size} edges "
                f"({sds.num_user} x {sds.num_item}, dim {cfg.dim_E}) on the CPU's sampled "
                f"graphs (the card's sampler attention within {att_err:.2e} of the CPU's), each "
                f"step card vs CPU from the CPU's params: worst loss rel {loss_all:.2e} (bound "
                f"{STEP_LOSS_RTOL:g}); worst gradient {worst_all[1]} at {worst_all[0]:.3f} of its "
                f"bound; clipped entries on the other side {flips}; the card's K2 launches "
                f"fwd/dq/dk {launched} (expected {(steps * GFORMER_TERMS,) * 3})")
            check(loss_all <= STEP_LOSS_RTOL and worst_all[0] <= 1.0
                  and launched == (steps * GFORMER_TERMS,) * 3, "GFormer card steps disagree")
        del cpu_model, card_model, trainer, family
    torch.cuda.empty_cache()
    # BSPM's scores, card against CPU, and two card builds' bits -----------
    # (phase 39's beauty-sized factors kept aside for phase 42's profile)
    cfg, _ = path_config("BSPM", args)
    kept, out = dict(bspm._SPECTRAL_CACHE), {}
    for label, on in (("cpu", torch.device("cpu")), ("card", device), ("card", device)):
        bspm._SPECTRAL_CACHE.clear()
        model = build_model(cfg, sds, on)
        ids = torch.arange(sds.num_user, device=on)
        with deterministic_mode():
            scores = model.score_users({}, ids)
            ranks = rank_from_scores(model, {}, torch.from_numpy(sds.history.values).to(on))
        out.setdefault(label, []).append((model.b.cpu(), scores.cpu(), ranks.cpu(),
                                            model.build_seconds))
    bspm._SPECTRAL_CACHE.clear()
    bspm._SPECTRAL_CACHE.update(kept)
    (_, c_scores, _, c_s), = out["cpu"]
    (b1, s1, r1, g_s1), (b2, s2, r2, g_s2) = out["card"]
    rel = ((s1 - c_scores).abs().max() / c_scores.abs().max()).item()
    say("famstep", f"BSPM scores of all {sds.num_user} users ({sds.num_item} items, q "
        f"{b1.shape[1]}), card vs CPU: max abs diff {rel:.2e} of the largest score (bound "
        f"{BSPM_SCORE_TOL:g}); builds: CPU {c_s:.3f} s, card {g_s1:.3f} s and {g_s2:.3f} s")
    check(rel <= BSPM_SCORE_TOL, "BSPM's card scores disagree with the CPU's")
    line = {"determinism": "BSPM", "steps": "two builds from an empty spectral cache, "
            f"{sds.num_user} x {sds.num_item}", "equal_loss_bits": bool(torch.equal(b1, b2)
                                                                       and torch.equal(s1, s2)),
            "equal_rank_lists": bool(torch.equal(r1, r2)),
            "finite": bool(torch.isfinite(s1).all()), "seconds": [round(g_s1, 3), round(g_s2, 3)]}
    print(json.dumps(line), flush=True)
    check(line["equal_loss_bits"] and line["equal_rank_lists"] and line["finite"],
          f"BSPM: two builds on one seed differ: {line}")

    # 42. famprofile: one step of each at beauty under the profiler ----------
    groups = {"K2 (lse_)": ("lse_",),
              "GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90"),
              "index kernels (gathers, their scatters, index_add_, sorts)": (
                  "index", "gather", "scatter", "sort", "radix"),
              "embedding_bag (fixed-order segment sums)": ("embedding_bag", "embeddingbag"),
              "reductions (norms, sums, softmax, logsumexp)": ("reduce_kernel", "softmax",
                                                               "logsumexp"),
              "elementwise": ("elementwise",)}
    for name in FAMILY_MODELS:
        cfg, _ = path_config(name, args)
        model = build_model(cfg, ds, device)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        if name == "BSPM":
            chunk = torch.arange(min(cfg.eval_user_chunk, ds.num_user), device=device)
            what = (f"one BSPM evaluation chunk of {chunk.shape[0]} users (the ideal "
                    f"filter, blur, {model.k_s} Euler steps: {2 + model.k_s} products with the "
                    f"{ds.num_item}^2 Gram or the factors)")

            def fn():
                with deterministic_mode():
                    model.score_users({}, chunk)
        else:
            family = getattr(model, "trainer_cls", Trainer)(model, ds, cfg)
            trainer = getattr(family, "_base", family)
            params = trainer.init_params()
            opt = trainer.make_optimizer(params)
            batch = first_batch(trainer, cfg)
            what = f"one {name} training step of {cfg.batch_size} edges (forward, backward, Adam)"
            if name == "GFormer":
                t0 = time.perf_counter()
                with deterministic_mode():
                    graphs = family.sample_graphs(params)
                torch.cuda.synchronize()
                say("famprofile", f"GFormer: one host resample (candidate edges, the card's "
                    f"attention, the masks, the bags of the four graphs) "
                    f"{time.perf_counter() - t0:.3f} s; edges: encoder "
                    f"{graphs.enc.rows.shape[0]}, decoder {graphs.dec.rows.shape[0]}, sub "
                    f"{graphs.sub.rows.shape[0]}, cmp {graphs.cmp.rows.shape[0]}")
                what += ", clip"

                def fn():
                    with deterministic_mode():
                        family.train_step(params, opt, batch, graphs)
            else:
                def fn():
                    trainer.train_step(params, opt, batch)
        reset_counts()
        device_profile("famprofile", f"{what} at {LINEAR_DATASET}", fn,
                       os.path.join(args.out_dir, f"chip_smoke_{name.lower()}_step_profile.txt"),
                       groups=groups)
        k2, others = lse_counts(), other_counts(*kernel_wrappers()[3:6])
        say("famprofile", f"{name} peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K2 launches {k2}, other "
            f"kernels {others}")
        # device_profile calls the step three times: warm-up, timed, profiled
        expected = (3 * GFORMER_TERMS if name == "GFormer" else 0,) * 3
        check(not any(others) and k2 == expected,
              f"{name} profile launched {k2} (expected {expected}) and {others}")
        del model
        torch.cuda.empty_cache()
    bspm._SPECTRAL_CACHE.clear()
    return time.perf_counter() - t_start, gformer_launches, lse


def check_export_skipped(phase: str, name: str, cfg) -> None:
    """``name``'s CLI run logged the JAX CLI's warning and wrote no
    artifact (a family trainer that keeps no weights of its own)."""
    log = open(os.path.join(cfg.log_dir, f"{name}_{cfg.data_path}.log")).read()
    skipped = "export_artifact: best combo's trainer kept no weights - skipping export"
    check(skipped in log and not os.path.exists(cfg.export_artifact),
          f"{name}: the export was not skipped")
    say(phase, f"{name} --export_artifact: skipped with the JAX CLI's warning, no file "
        "(its trainer keeps no weights of its own)")


def family2_cli_run(device, ds, name, cfg, grid) -> tuple:
    """Phase 43's ``cli.run`` of AdaGCL or Grade on ``ds``: each epoch's
    loss, walls (and the training wall a step), eval users per second and
    peak memory; K4's launches against ``scan_launches`` (each step and each
    evaluation), no other kernel; the export skipped. Returns (the model,
    K4's launches)."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum

    probe = EpochProbe()
    logging.getLogger().addFilter(probe)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with BuildProbe() as built:
            best = cli.run(cfg, grid, ds, device)
            torch.cuda.synchronize()
    finally:
        logging.getLogger().removeFilter(probe)
    run_s = time.perf_counter() - t0
    k4, others = prefix_cumsum.launches, other_counts(prefix_cumsum)
    model = built.models[0]
    check(len(built.models) == 1 and model.device.type == device.type,
          f"{name} is not on the card")
    combo = {k: grid[k][0] for k in grid["hyper_parameters"]}
    n_batches = math.ceil(ds.num_edges / cfg.batch_size)
    per_step, per_eval = scan_launches(cfg.replace(**combo))
    expected = cfg.num_epoch * (n_batches * per_step + per_eval)
    for e, ep in enumerate(probe.epochs):
        say("family2", f"{name} epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
            f"(training {ep['train_s']:.3f} s, {1e3 * ep['train_s'] / n_batches:.2f} ms a step; "
            f"eval {ep['eval_s']:.3f} s: {ds.num_user / ep['eval_s']:.0f} users/s), peak device "
            f"memory {ep['peak_gib']:.2f} GiB")
    say("family2", f"{name} cli.run {combo}: {cfg.num_epoch} epochs x {n_batches} batches of "
        f"{cfg.batch_size} edges: {run_s:.3f} s wall; prefix_cumsum launches {k4} (expected "
        f"{expected} = {cfg.num_epoch} x ({n_batches} x {per_step} + {per_eval} eval), each at "
        f"({2 * ds.num_edges}, {cfg.dim_E})), other kernels {others} (expected none)")
    check(k4 == expected and not any(others), f"{name} launched {k4} and {others}")
    check(len(probe.epochs) == cfg.num_epoch, f"{len(probe.epochs)} epochs logged")
    check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
    check(sorted(best) == [5, 10, 20] and all(
        math.isfinite(v) for m in best.values() for v in m.values()), f"best {best}")
    say("family2", f"{name} best test metrics: " + "; ".join(
        f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in best.items()))
    check_export_skipped("family2", name, cfg)
    return model, k4


def adam_reference(p0, m0, v0, count, g, lr, eps, betas=(0.9, 0.999), weight_decay=0.0):
    """(p, m, v) of one Adam step in float64 from (p0, m0, v0) after
    ``count`` steps, on the gradient g (``weight_decay``: AdamW's, p0 scaled
    by 1 - lr weight_decay first)."""
    b1, b2 = betas
    p0, m0, v0, g = (x.double() for x in (p0, m0, v0, g))
    p0 = p0 * (1 - lr * weight_decay)
    t = count + 1
    m = b1 * m0 + (1 - b1) * g
    v = b2 * v0 + (1 - b2) * g * g
    return p0 - lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps), m, v


def adam_state(opt, p):
    """(step, exp_avg, exp_avg_sq) of ``p`` in ``opt``, copied to the CPU
    (zeros before its first step)."""
    s = opt.state.get(p)
    if not s:
        return 0, torch.zeros(p.shape), torch.zeros(p.shape)
    return int(s["step"]), s["exp_avg"].detach().cpu().clone(), s["exp_avg_sq"].detach().cpu().clone()


def set_adam_state(opt, p, step, m, v):
    """``p``'s state in ``opt`` set to (step, m, v), made as torch's Adam
    makes it at a param's first step if ``p`` has none yet."""
    s = opt.state[p]
    if not s:
        s["step"] = torch.zeros((), dtype=torch.float32)
        s["exp_avg"], s["exp_avg_sq"] = torch.zeros_like(p), torch.zeros_like(p)
    s["step"].fill_(step)
    s["exp_avg"].copy_(m)
    s["exp_avg_sq"].copy_(v)


@contextlib.contextmanager
def kernel_order_prefix():
    """The segment sums' prefix of host tensors in K4's own summation order
    (``ops/prefix_scan.prefix_cumsum_kernel_order``, bit for bit the
    kernel's) instead of torch.cumsum, which on the CPU rounds once. For the
    comparisons only."""
    from chaorec_tpu_torch.ops import ell
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum_kernel_order

    plain = ell.prefix_cumsum
    ell.prefix_cumsum = prefix_cumsum_kernel_order
    try:
        yield
    finally:
        ell.prefix_cumsum = plain


def multi_opt_card_vs_cpu(name, cfg, sds, device, card_ctx=contextlib.nullcontext) -> dict:
    """Phase 46 for AdaGCL and Grade: FAMILY2_STEP_BATCHES batches of the
    family trainer's step on the CPU and on ``device`` (under ``card_ctx``),
    on the same batches and draws, the card on the CPU's side of every
    ReLU, clip and cut (Kinks, Cuts), each optimizer step of the card's
    from the CPU's params and optimizer state before it (set in the step's
    hook). The CPU's segment sums take their prefixes in K4's own summation
    order (``kernel_order_prefix``), so the two steps share every prefix
    rounding and differ in the other operations' only.

    Each gradient is held within the larger of the STEP bounds and
    SPREAD_FACTOR times its spread: how far it moves when the CPU steps
    from inputs nudged by 2^-24 of each entry (the step's own condition).
    Checked: the optimizer steps' order and counts; each batch's summed
    loss and each optimizer step's gradient against the CPU's; the card's
    params and moments after each optimizer step against the float64 Adam
    step of the CPU's inputs with the card's own gradient (ADAM_STEP_RTOL of
    the tensor's largest entry). Adam divides a gradient by its running
    root mean square, so an entry whose gradient is within rounding of 0
    can move by up to the learning rate either way: the entries where the
    card's params end more than STEP_RTOL of the tensor's largest entry
    from the CPU's are counted, not bounded. Measured, not bounded: how far
    K4's summation order moves each gradient from the same CPU step with
    prefixes summed in double and rounded once (``order``, in shares of the
    gradient's bound). Returns {loss, grad, adam, order (worst shares),
    off, flips, cut_flips, k4 (the card's K4 launches a batch), steps,
    knn_rows (Grade: the items whose multimodal kNN neighbours the card's
    own build picked otherwise; the card takes the CPU's graph)}."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches
    from chaorec_tpu_torch.models import adagcl, build_model, grade
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum
    from chaorec_tpu_torch.params import clone_to
    from chaorec_tpu_torch.train.loop import deterministic_mode

    step_fn = adagcl.alternating_step if name == "AdaGCL" else grade.grade_step
    cpu_model = build_model(cfg, sds, "cpu")
    models = {"cpu": cpu_model, "card": build_model(cfg, sds, device), "nudged": cpu_model,
              "exact": cpu_model}
    knn_rows = 0
    if name == "AdaGCL":  # each device's generator draws its own frozen copy
        models["card"].load_frozen_feats(cpu_model.frozen_feats)
    else:  # each device's top-k picks its own neighbours where two nearly tie
        cpu_g, card_g = cpu_model.mm_graph, models["card"].mm_graph
        knn_rows = int((torch.sort(card_g.indices.cpu(), 1).values
                        != torch.sort(cpu_g.indices, 1).values).any(1).sum())
        models["card"].mm_graph = dataclasses.replace(
            cpu_g, indices=cpu_g.indices.to(device), weights=cpu_g.weights.to(device))
    fams = {k: m.trainer_cls(m, sds, cfg) for k, m in models.items()}
    base = fams["cpu"]._base
    params = {"cpu": base.init_params()}
    for side in ("card", "nudged", "exact"):
        params[side] = {k: v.detach().to(models[side].device, copy=True).requires_grad_()
                        for k, v in params["cpu"].items()}
    opts = {k: (f.make_optimizer(params[k]), *f.gen_opts) for k, f in fams.items()}
    n_main = 3 if name == "AdaGCL" else 2
    labels = ([f"main{i + 1}" for i in range(n_main)]
              + [f"g{i + 1}" for i in range(len(opts["cpu"]) - 1)])
    nudge_gen = torch.Generator().manual_seed(46)

    def index(label):  # the optimizer of a step label, as an index into opts
        return 0 if label.startswith("main") else int(label[1:])

    def names_of(side, j):
        mine = {id(p) for grp in opts[side][j].param_groups for p in grp["params"]}
        return [k for k, p in params[side].items() if id(p) in mine]

    def set_side(side, inputs, states):
        """``side``'s params (nudged by 2^-24 of each entry on that side),
        and the states of optimizers ``states`` ({j: {name: (step, m,
        v)}}), set to the CPU's."""
        on = models[side].device
        with torch.no_grad():
            for k, p in params[side].items():
                x = inputs[k]
                if side == "nudged":
                    x = x * (1 + 2.0 ** -24 * torch.randn(x.shape, generator=nudge_gen))
                p.copy_(x)
        for j, st in states.items():
            for k, (step, m, v) in st.items():
                if step or opts[side][j].state.get(params[side][k]):
                    set_adam_state(opts[side][j], params[side][k], step, m.to(on), v.to(on))

    lr = float(cfg.learning_rate)
    out = dict(loss=0.0, grad=(0.0, ""), adam=(0.0, ""), order=(0.0, ""), off=0, flips=0,
               cut_flips=0, k4=[], steps=labels, knn_rows=knn_rows)
    batches = make_edge_batches(base.generator, base.edges, cfg.batch_size)
    for b in range(FAMILY2_STEP_BATCHES):
        batch = base.bpr_batch(batches[b])
        draws = cpu_model.draws(base.generator, batch)
        start_params = {k: p.detach().clone() for k, p in params["cpu"].items()}
        start_states = {j: {k: adam_state(o, params["cpu"][k]) for k in names_of("cpu", j)}
                        for j, o in enumerate(opts["cpu"])}
        rec = {}

        def hook(side):
            def on_step(label):
                j = index(label)
                mine = names_of(side, j)
                rec[side].append(dict(
                    label=label, names=mine,
                    params={k: p.detach().cpu().clone() for k, p in params[side].items()},
                    grads={k: params[side][k].grad.detach().cpu().clone() for k in mine},
                    state={k: adam_state(opts[side][j], params[side][k]) for k in mine}))
                if side != "cpu":  # the next optimizer step from the CPU's inputs
                    cpu = rec["cpu"][len(rec[side]) - 1]
                    set_side(side, cpu["params"], {j: cpu["state"]})
            return on_step

        kinks, cuts = Kinks(), Cuts()
        losses = {}
        # the CPU in K4's order; the card through K4; the CPU nudged; the CPU
        # with its own prefixes (summed in double, rounded once)
        for side, ctx in (("cpu", kernel_order_prefix), ("card", card_ctx),
                          ("nudged", kernel_order_prefix), ("exact", contextlib.nullcontext)):
            on = models[side].device
            rec[side] = []
            if side != "cpu":
                set_side(side, start_params, start_states)
            reset_counts()
            pins = (kinks.record(), cuts.record()) if side == "cpu" else (kinks.replay(),
                                                                          cuts.replay())
            with ctx(), deterministic_mode(), pinned_sides(*pins):
                losses[side] = step_fn(models[side], opts[side], params[side],
                                       batch_to(batch, on), clone_to(draws, on),
                                       on_step=hook(side)).item()
            if side == "card":
                out["k4"].append(prefix_cumsum.launches)
                out["flips"] += kinks.flips
                out["cut_flips"] += cuts.flips
                others = other_counts(prefix_cumsum)
                check(not any(others), f"{name} card step launched {others}")
            check([e["label"] for e in rec[side]] == labels,
                  f"{name} {side}: the optimizer steps ran {[e['label'] for e in rec[side]]}")
        out["loss"] = max(out["loss"], abs(losses["card"] - losses["cpu"]) / max(
            STEP_LOSS_RTOL * abs(losses["cpu"]),
            SPREAD_FACTOR * abs(losses["nudged"] - losses["cpu"])))
        states = {j: dict(s) for j, s in start_states.items()}
        for i, c in enumerate(rec["cpu"]):
            g = rec["card"][i]
            j = index(c["label"])
            eps = opts["cpu"][j].param_groups[0]["eps"]
            inputs = start_params if i == 0 else rec["cpu"][i - 1]["params"]
            scale = max(w.abs().max().item() for w in c["grads"].values())
            for k, want in c["grads"].items():
                base_tol = STEP_RTOL * want.abs().max().item() + STEP_ATOL * scale
                drift = (rec["nudged"][i]["grads"][k] - want).abs().max().item()
                bound = max(base_tol, SPREAD_FACTOR * drift)
                what = f"{k} of {c['label']}"
                out["grad"] = max(out["grad"], ((g["grads"][k] - want).abs().max().item() / bound,
                                                what))
                out["order"] = max(out["order"], (
                    (rec["exact"][i]["grads"][k] - want).abs().max().item() / bound, what))
            for k in c["names"]:
                step, m0, v0 = states[j][k]
                p, m, v = adam_reference(inputs[k], m0, v0, step, g["grads"][k], lr, eps)
                check(g["state"][k][0] == step + 1 == c["state"][k][0],
                      f"{name} {c['label']}: {k}'s step count")
                for what, got, want in (("", g["params"][k], p),
                                        (" first moment", g["state"][k][1], m),
                                        (" second moment", g["state"][k][2], v)):
                    err = (got.double() - want).abs().max().item()
                    share = err / (ADAM_STEP_RTOL * want.abs().max().item() + 1e-30)
                    out["adam"] = max(out["adam"], (share, f"{k}{what} after {c['label']}"))
                bound = STEP_RTOL * c["params"][k].abs().max().item() + STEP_ATOL
                out["off"] += int(((g["params"][k] - c["params"][k]).abs() > bound).sum())
            for k in set(inputs) - set(c["names"]):  # the other params did not move
                check(torch.equal(g["params"][k], inputs[k]),
                      f"{name} {c['label']} moved {k}, not its optimizer's")
            states[j] = c["state"]
        for side in ("card", "nudged", "exact"):  # each side's copies end as the CPU's
            set_side(side, params["cpu"], {})
    return out


def family2_phases(args, device, ds) -> tuple:
    """Phases 43-47: AdaGCL's and Grade's CLI runs on beauty through K4 (the
    export skipped), K4 at their shape, the four towers' CLI runs (MGCL's
    export served), one step of each of the six on the card against the
    CPU (AdaGCL and Grade over FAMILY2_STEP_BATCHES batches, optimizer step
    by optimizer step), and each one's step profile. Returns (their wall
    seconds, K4's launches of each CLI run, K4's results at their
    shape)."""
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum
    from chaorec_tpu_torch.train.loop import Trainer

    t_start = time.perf_counter()
    # 43. family2: cli.run of AdaGCL and Grade at their first combo ---------
    k4_runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in FAMILY2_MODELS:
            cfg, _ = path_config(name, args)
            model, k4_runs[name] = family2_cli_run(device, ds, name, cfg.replace(
                num_epoch=FAMILY2_EPOCHS, log_dir=args.out_dir,
                export_artifact=os.path.join(tmp, f"{name}.npz")), first_combo(name)[1])
            dim = model.dim_E
            del model
            torch.cuda.empty_cache()

    # 44. k4ag: K4 at their shape, the doubled edges by dim_E --------------
    gen = torch.Generator(device=device).manual_seed(args.seed + 44)
    m = 2 * ds.num_edges
    k4ag = dict(shape=[m, dim], max_abs_err=k4_hold("k4ag", gen, device, (m, dim)))
    k4ag.update(k4_times("k4ag", gen, device, "adagcl_grade", m, dim))
    torch.cuda.empty_cache()

    # 45. towers: cli.run of the four, MGCL's export served -----------------
    with tempfile.TemporaryDirectory() as tmp:
        for name in TOWER_MODELS:
            cfg, _ = path_config(name, args)
            art = os.path.join(tmp, f"{name}.npz") if name == TOWER_SERVED else ""
            models, _ = linear_cli_run("towers", device, ds, name, cfg.replace(
                num_epoch=TOWER_EPOCHS, log_dir=args.out_dir, export_artifact=art),
                first_combo(name)[1])
            check(models[0].device.type == device.type, f"{name} is not on the card")
            if art:
                reset_counts()
                check_embeddings_serving("towers", art, ds, device, name)
                check(not any(other_counts()), f"{name} serving launched {other_counts()}")
            del models
            torch.cuda.empty_cache()

    # 46. fam2step: one step of each on the card against the CPU's ---------
    # on phase 32's seeded set with features, float32 R, equal params, batch
    # and draws, the card held to the CPU's side of each kink (Kinks, Cuts)
    sds = synthetic_dataset(LINEAR_DATASET, args.seed + 1, shape=STEP_SHAPE, features=True)
    for name in TOWER_MODELS:
        cfg, _ = path_config(name, args)
        cfg = cfg.replace(graph_compute_dtype="float32")
        cpu_model, card_model = build_model(cfg, sds, "cpu"), build_model(cfg, sds, device)
        trainer = Trainer(cpu_model, sds, cfg)
        params = trainer.init_params()
        batch = first_batch(trainer, cfg)
        draws = cpu_model.draws(trainer.generator, batch) if hasattr(cpu_model, "draws") else None
        kinks, cuts = Kinks(), Cuts()
        c_loss, c_grads, _ = device_step(cpu_model, params, None, batch, draws,
                                         pinned_sides(kinks.record(), cuts.record()))
        reset_counts()
        g_loss, g_grads, _ = device_step(card_model, params, None, batch, draws,
                                         pinned_sides(kinks.replay(), cuts.replay()))
        worst, loss_rel, others = worst_share(g_grads, c_grads), abs(g_loss - c_loss) / abs(
            c_loss), other_counts()
        say("fam2step", f"one {name} step of {batch.users.shape[0]} edges on a float32 R "
            f"({sds.num_user} x {sds.num_item}, dim {cfg.dim_E}, 4096- and 384-wide features), "
            f"card vs CPU on the same params, batch, negatives"
            f"{', dropout masks' if draws else ''}: loss {g_loss:.7f} vs {c_loss:.7f} (rel "
            f"{loss_rel:.2e}, bound {STEP_LOSS_RTOL:g}); worst gradient {worst[1]} at "
            f"{worst[0]:.3f} of its bound; ReLU units on the other side {kinks.flips}, clip "
            f"entries {cuts.flips}; kernel launches {others}")
        check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0 and not any(others),
              f"{name} card step disagrees")
        del cpu_model, card_model, trainer
    for name in FAMILY2_MODELS:
        cfg, _ = path_config(name, args)
        cfg = cfg.replace(graph_compute_dtype="float32")
        r = multi_opt_card_vs_cpu(name, cfg, sds, device)
        per_step = scan_launches(cfg)[0]
        say("fam2step", f"{name}, {FAMILY2_STEP_BATCHES} batches of {cfg.batch_size} edges "
            f"({sds.num_user} x {sds.num_item}, dim {cfg.dim_E}, {cfg.n_layers} layers), each "
            f"optimizer step ({', '.join(r['steps'])}) of the card's from the CPU's params and "
            f"state, same batch and draws: worst loss at {r['loss']:.3f} of its bound, worst "
            f"gradient {r['grad'][1]} at {r['grad'][0]:.3f} of its bound (each the larger of the "
            f"step bounds and {SPREAD_FACTOR:g} x its spread, the CPU's step from inputs nudged by "
            f"2^-24; the CPU's prefixes in K4's summation order); K4's order against prefixes "
            f"rounded once moves {r['order'][1]} by {r['order'][0]:.3f} of its bound (not "
            f"bounded); the card's Adam steps against float64 Adam on its own gradient: worst "
            f"{r['adam'][1]} at {r['adam'][0]:.3f} of {ADAM_STEP_RTOL:g} of the tensor's max; "
            f"entries the Adam steps left more than {STEP_RTOL:g} of the tensor's max from the "
            f"CPU's (a gradient within rounding of 0) {r['off']}; ReLU units on the other side "
            f"{r['flips']}, clip and cut entries {r['cut_flips']}; the card's K4 launches a "
            f"batch {r['k4']} (expected {per_step})"
            + (f"; items whose kNN neighbours the card's own build picked otherwise "
               f"{r['knn_rows']} (the card takes the CPU's graph)" if name == "Grade" else ""))
        check(r["loss"] <= 1.0 and r["grad"][0] <= 1.0 and r["adam"][0] <= 1.0
              and r["k4"] == [per_step] * FAMILY2_STEP_BATCHES, f"{name} card steps disagree")
    torch.cuda.empty_cache()

    # 47. fam2profile: one step of each at beauty under the profiler --------
    groups = {"K4 (prefix scan)": ("prefix_scan", "lookback"),
              "GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90"),
              "index kernels (gathers, their scatters, index_add_, sorts)": (
                  "index", "gather", "scatter", "sort", "radix"),
              "embedding_bag (fixed-order segment sums)": ("embedding_bag", "embeddingbag"),
              "reductions (norms, sums, softmax, logsumexp)": ("reduce_kernel", "softmax",
                                                               "logsumexp"),
              "elementwise": ("elementwise",)}
    for name in FAMILY2_MODELS + TOWER_MODELS:
        cfg, _ = path_config(name, args)
        model = build_model(cfg, ds, device)
        family = getattr(model, "trainer_cls", Trainer)(model, ds, cfg)
        trainer = getattr(family, "_base", family)
        params = trainer.init_params()
        opt = trainer.make_optimizer(params)
        batch = first_batch(trainer, cfg)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        step = family.train_step if family is not trainer else trainer.train_step
        device_profile("fam2profile", f"one {name} training step of {cfg.batch_size} edges at "
                       f"{LINEAR_DATASET} (forward, backward, every optimizer)",
                       lambda: step(params, opt, batch),
                       os.path.join(args.out_dir, f"chip_smoke_{name.lower()}_step_profile.txt"),
                       groups=groups)
        k4, others = prefix_cumsum.launches, other_counts(prefix_cumsum)
        # device_profile calls the step three times: warm-up, timed, profiled
        expected = 3 * scan_launches(cfg)[0] if name in FAMILY2_MODELS else 0
        say("fam2profile", f"{name} peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K4 launches {k4} (expected "
            f"{expected}), other kernels {others}")
        check(k4 == expected and not any(others), f"{name} profile launched {k4} and {others}")
        del model, family, trainer, params, opt
        torch.cuda.empty_cache()
    return time.perf_counter() - t_start, k4_runs, k4ag


def towers2_phases(args, device, ds) -> float:
    """Phases 48-50: the seven towers' CLI runs on beauty (MMGCN's and
    MVGAE's frozen tensors held, DDRec's export served), one step of each
    on the card against the CPU (DDRec over TOWER2_STATE_BATCHES batches,
    its state carried), and each one's step profile (MENTOR's full-table
    InfoNCE timed alone); no kernel launch expected anywhere. Returns their
    wall seconds."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches
    from chaorec_tpu_torch.graphs.knn import ELLGraph
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.models.mentor import full_table_infonce
    from chaorec_tpu_torch.params import load_frozen
    from chaorec_tpu_torch.train.loop import Trainer

    t_start = time.perf_counter()
    # 48. towers2: cli.run of each at its first combo, DDRec's export served
    with tempfile.TemporaryDirectory() as tmp:
        for name in TOWER2_MODELS:
            cfg, _ = path_config(name, args)
            art = os.path.join(tmp, f"{name}.npz") if name == TOWER2_SERVED else ""
            models, _ = linear_cli_run("towers2", device, ds, name, cfg.replace(
                num_epoch=TOWER_EPOCHS, log_dir=args.out_dir, export_artifact=art),
                first_combo(name)[1])
            model = models[0]
            check(model.device.type == device.type, f"{name} is not on the card")
            if hasattr(model, "frozen"):
                # a fresh build on the card draws them again from the seed
                fresh = build_model(cfg, ds, device)
                same = [bool(torch.equal(getattr(model, n), getattr(fresh, n)))
                        for n in model.frozen]
                say("towers2", f"{name}'s frozen {', '.join(model.frozen)} after "
                    f"{TOWER_EPOCHS} epochs bit-equal to a fresh build's: {same}")
                check(all(same), f"{name}: a frozen tensor moved")
                del fresh
            if art:
                reset_counts()
                check_embeddings_serving("towers2", art, ds, device, name)
                check(not any(other_counts()), f"{name} serving launched {other_counts()}")
            del models, model
            torch.cuda.empty_cache()

    # 49. tw2step: one step of each on the card against the CPU's -----------
    # on phase 32's seeded set with features, float32 R, equal params, batch,
    # frozen tensors and draws, the card held to the CPU's side of each kink
    sds = synthetic_dataset(LINEAR_DATASET, args.seed + 1, shape=STEP_SHAPE, features=True)
    for name in TOWER2_MODELS:
        cfg, _ = path_config(name, args)
        cfg = cfg.replace(graph_compute_dtype="float32")
        cpu_model, card_model = build_model(cfg, sds, "cpu"), build_model(cfg, sds, device)
        given = []
        if hasattr(cpu_model, "frozen"):  # each device's generator draws its own
            load_frozen(card_model, {n: getattr(cpu_model, n) for n in cpu_model.frozen})
            given.append("frozen tensors")
        if hasattr(cpu_model, "mm_graph"):
            # the card's own top-k may pick another neighbour where two nearly tie
            knn_rows = int((card_model.mm_graph.indices.cpu() != cpu_model.mm_graph.indices)
                           .any(1).sum())
            card_model.mm_graph = ELLGraph(cpu_model.mm_graph.indices.to(device),
                                           cpu_model.mm_graph.weights.to(device))
            given.append(f"the CPU's kNN graph (rows the card's own build picked otherwise: "
                         f"{knn_rows})")
        trainer = Trainer(cpu_model, sds, cfg)
        params, state = trainer.init_params(), trainer.model_state
        if name == "POWERec":
            cpu_model.pre_epoch(params, 0)
            card_model.pre_epoch(params, 0)
            cr, gr = cpu_model.masked_r, card_model.masked_r.cpu()
            check(torch.equal(cr != 0, gr != 0) and torch.allclose(gr, cr, rtol=1e-6, atol=0),
                  "POWERec: the card pruned another R")
            given.append("epoch 0's pruned R (the same kept edges)")
        batches = make_edge_batches(trainer.generator, trainer.edges, cfg.batch_size)
        n_steps = TOWER2_STATE_BATCHES if cpu_model.stateful else 1
        nudge_gen = torch.Generator().manual_seed(49)
        for b in range(n_steps):
            batch = trainer.bpr_batch(batches[b])
            draws = (cpu_model.draws(trainer.generator, batch) if hasattr(cpu_model, "draws")
                     else None)
            kinks, cuts = Kinks(), Cuts()
            c_loss, c_grads, c_state = device_step(cpu_model, params, state, batch, draws,
                                                   pinned_sides(kinks.record(), cuts.record()))
            reset_counts()
            g_loss, g_grads, g_state = device_step(card_model, params, state, batch, draws,
                                                   pinned_sides(kinks.replay(), cuts.replay()))
            worst, loss_rel, others = worst_share(g_grads, c_grads), abs(g_loss - c_loss) / abs(
                c_loss), other_counts()
            # not a gate: how far the CPU's own step moves from params nudged
            # by 2^-24 of each entry, on the same kink sides
            nudged = {k: v.detach() * (1 + 2.0 ** -24 * torch.randn(v.shape, generator=nudge_gen))
                      for k, v in params.items()}
            _, n_grads, _ = device_step(cpu_model, nudged, state, batch, draws,
                                        pinned_sides(kinks.replay(), cuts.replay()))
            spread = worst_share(n_grads, c_grads)
            state_msg, state_ok = "", True
            if c_state is not None:
                s_worst = worst_share(g_state, c_state)
                state_ok = s_worst[0] <= 1.0
                state_msg = (f"; new state (has_prev {float(c_state['0']):g}): worst "
                             f"{s_worst[1]} at {s_worst[0]:.3f} of the same bound")
                state = (c_state["0"], c_state["1"])  # the next batch from the CPU's
            say("tw2step", f"one {name} step{f' (batch {b + 1} of {n_steps})' if n_steps > 1 else ''}"
                f" of {batch.users.shape[0]} edges on a float32 R ({sds.num_user} x "
                f"{sds.num_item}, dim {cfg.dim_E}, 4096- and 384-wide features), card vs CPU "
                f"on the same params, batch, negatives{', draws' if draws else ''}"
                f"{''.join(', ' + g for g in given)}: loss {g_loss:.7f} vs {c_loss:.7f} (rel "
                f"{loss_rel:.2e}, bound {STEP_LOSS_RTOL:g}); worst gradient {worst[1]} at "
                f"{worst[0]:.3f} of its bound (the CPU's own step from params nudged by 2^-24: "
                f"{spread[1]} at {spread[0]:.3f}, not a gate){state_msg}; LeakyReLU units on the "
                f"other side "
                f"{kinks.flips}, clamp, cut, weakest and sign entries {cuts.flips}; kernel "
                f"launches {others}")
            check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0 and state_ok
                  and not any(others), f"{name} card step disagrees")
        del cpu_model, card_model, trainer
    torch.cuda.empty_cache()

    # 50. tw2profile: one step of each at beauty under the profiler ---------
    groups = {"GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90"),
              "index kernels (gathers, their scatters, index_add_, sorts)": (
                  "index", "gather", "scatter", "sort", "radix"),
              "embedding_bag (fixed-order segment sums)": ("embedding_bag", "embeddingbag"),
              "reductions (norms, sums, softmax, logsumexp)": ("reduce_kernel", "softmax",
                                                               "logsumexp"),
              "elementwise": ("elementwise",)}
    for name in TOWER2_MODELS:
        cfg, _ = path_config(name, args)
        model = build_model(cfg, ds, device)
        trainer = Trainer(model, ds, cfg)
        params = trainer.init_params()
        opt = trainer.make_optimizer(params)
        model.pre_epoch(params, 0)
        batch = first_batch(trainer, cfg)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        wall_ms, busy_ms = device_profile(
            "tw2profile", f"one {name} training step of {cfg.batch_size} edges at "
            f"{LINEAR_DATASET} (forward, backward, Adam)",
            lambda: trainer.train_step(params, opt, batch),
            os.path.join(args.out_dir, f"chip_smoke_{name.lower()}_step_profile.txt"),
            groups=groups)
        others = other_counts()
        say("tw2profile", f"{name} step peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; kernel launches {others}")
        check(not any(others), f"{name} step launched {others}")
        if name == "MENTOR":
            # its two full-table InfoNCE terms alone, forward and backward, at
            # the step's shapes: the noisy reps are (U, 2 dim_E) and (I, 2 dim_E)
            gen = torch.Generator(device).manual_seed(args.seed + 50)
            reps = [torch.randn((n, 2 * cfg.dim_E), generator=gen, device=device,
                                requires_grad=True)
                    for n in (ds.num_user, ds.num_user, ds.num_item, ds.num_item)]

            def infonce():
                loss = (full_table_infonce(reps[0], reps[1], cfg.ssl_temp)
                        + full_table_infonce(reps[2], reps[3], cfg.ssl_temp))
                torch.autograd.grad(loss, reps)

            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = cuda_ms(infonce, 5)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            say("tw2profile", f"MENTOR's full-table InfoNCE ({ds.num_user} x {ds.num_user} and "
                f"{ds.num_item} x {ds.num_item} logits at width {2 * cfg.dim_E}), forward and "
                f"backward: {ms:.2f} ms, {100 * ms / busy_ms:.1f}% of the step's device time "
                f"({busy_ms:.1f} ms), {100 * ms / wall_ms:.1f}% of its wall ({wall_ms:.1f} ms); "
                f"{peak:.2f} GiB of device memory above its inputs")
            del reps
        del model, trainer, params, opt
        torch.cuda.empty_cache()
    return time.perf_counter() - t_start


def towers3_phases(args, device, ds) -> float:
    """Phases 51-53: the four towers' CLI runs on beauty (each build's
    seconds and peak memory, GUME's host kNN and dense graphs, GRCN's export
    served), one step of each on the card against the CPU, and each one's
    step profile (GUME's fp32 copies of its bf16 graphs in bdot's backward
    timed alone); no kernel launch expected anywhere. Returns their wall
    seconds."""
    from chaorec_tpu_torch.graphs.knn import ELLGraph
    from chaorec_tpu_torch.models import build_model, gume
    from chaorec_tpu_torch.train.loop import Trainer

    t_start = time.perf_counter()
    # 51. towers3: cli.run of each at its first combo, GRCN's export served --
    knn_s = []
    knn_indices = gume.knn_indices

    def timed_knn(feats, k):
        t0 = time.perf_counter()
        out = knn_indices(feats, k)
        knn_s.append((feats.shape, time.perf_counter() - t0))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        for name in TOWER3_MODELS:
            cfg, _ = path_config(name, args)
            art = os.path.join(tmp, f"{name}.npz") if name == TOWER3_SERVED else ""
            probe = BuildProbe()
            gume.knn_indices = timed_knn
            try:
                with probe:
                    models, _ = linear_cli_run("towers3", device, ds, name, cfg.replace(
                        num_epoch=TOWER_EPOCHS, log_dir=args.out_dir, export_artifact=art),
                        first_combo(name)[1])
            finally:
                gume.knn_indices = knn_indices
            model = models[0]
            check(model.device.type == device.type, f"{name} is not on the card")
            built = probe.builds[0]
            say("towers3", f"{name} build: {built['seconds']:.3f} s, peak device memory "
                f"{built['peak_gib']:.3f} GiB above what was allocated before it")
            if name == "GUME":
                dense = {n: getattr(model, n) for n in ("r_norm", "ii_norm", "image_adj",
                                                         "text_adj")}
                check(model.graph_bf16 and all(t.dtype == torch.bfloat16 for t in dense.values()),
                      "GUME's graphs are not dense bf16 on the card")
                say("towers3", "GUME's dense bf16 graphs: " + ", ".join(
                    f"{n} {tuple(t.shape)} {t.numel() * 2 / 1e6:.1f} MB"
                    for n, t in dense.items()) + "; its host kNN (numpy: the full similarity "
                    "and its argsort) " + ", ".join(f"{shape[0]} x {shape[1]} features "
                                                    f"{sec:.3f} s" for shape, sec in knn_s)
                    + f"; I-I intersection edges {model.ii_rows.shape[0]}")
            if art:
                reset_counts()
                check_embeddings_serving("towers3", art, ds, device, name)
                check(not any(other_counts()), f"{name} serving launched {other_counts()}")
            del models, model
            torch.cuda.empty_cache()

    # 52. tw3step: one step of each on the card against the CPU's -----------
    # on phase 32's seeded set with features, float32 graphs, equal params,
    # batch and draws, the CPU's kNN graphs, the card held to the CPU's side
    # of each kink
    sds = synthetic_dataset(LINEAR_DATASET, args.seed + 1, shape=STEP_SHAPE, features=True)
    for name in TOWER3_MODELS:
        cfg, _ = path_config(name, args)
        cfg = cfg.replace(graph_compute_dtype="float32")
        cpu_model, card_model = build_model(cfg, sds, "cpu"), build_model(cfg, sds, device)
        given = []
        adjs = [a for a in ("image_adj", "text_adj", "fusion_adj") if hasattr(cpu_model, a)]
        if adjs:
            # the card's own top-k may pick another neighbour where two nearly tie
            rows = sum(int((getattr(card_model, a).indices.cpu() != getattr(cpu_model, a).indices)
                           .any(1).sum()) for a in adjs if a != "fusion_adj")
            for a in adjs:
                g = getattr(cpu_model, a)
                setattr(card_model, a, ELLGraph(g.indices.to(device), g.weights.to(device)))
            given.append(f"the CPU's {', '.join(adjs)} (rows the card's own build picked "
                         f"otherwise: {rows})")
        trainer = Trainer(cpu_model, sds, cfg)
        params = trainer.init_params()
        batch = first_batch(trainer, cfg)
        draws = cpu_model.draws(trainer.generator, batch) if hasattr(cpu_model, "draws") else None
        kinks, cuts = Kinks(), Cuts()
        c_loss, c_grads, _ = device_step(cpu_model, params, None, batch, draws,
                                         pinned_sides(kinks.record(), cuts.record()))
        reset_counts()
        g_loss, g_grads, _ = device_step(card_model, params, None, batch, draws,
                                         pinned_sides(kinks.replay(), cuts.replay()))
        worst, loss_rel = worst_share(g_grads, c_grads), abs(g_loss - c_loss) / abs(c_loss)
        n_csr = check_step_launches("tw3step", card_model, 1)
        # not a gate: how far the CPU's own step moves from params nudged by
        # 2^-24 of each entry, on the same kink sides
        nudge_gen = torch.Generator().manual_seed(52)
        nudged = {k: v.detach() * (1 + 2.0 ** -24 * torch.randn(v.shape, generator=nudge_gen))
                  for k, v in params.items()}
        _, n_grads, _ = device_step(cpu_model, nudged, None, batch, draws,
                                    pinned_sides(kinks.replay(), cuts.replay()))
        spread = worst_share(n_grads, c_grads)
        say("tw3step", f"one {name} step of {batch.users.shape[0]} edges on float32 graphs "
            f"({sds.num_user} x {sds.num_item}, dim {cfg.dim_E}, 4096- and 384-wide features), "
            f"card vs CPU on the same params, batch, negatives"
            f"{', draws' if draws else ''}{''.join(', ' + g for g in given)}: loss "
            f"{g_loss:.7f} vs {c_loss:.7f} (rel {loss_rel:.2e}, bound {STEP_LOSS_RTOL:g}); "
            f"worst gradient {worst[1]} at {worst[0]:.3f} of its bound (the CPU's own step from "
            f"params nudged by 2^-24: {spread[1]} at {spread[0]:.3f}, not a gate); ReLU and "
            f"LeakyReLU units on the other side {kinks.flips}, clamp, modality, sign and gap "
            f"entries {cuts.flips}; csr_spmm launches {n_csr}, no other kernel")
        check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0, f"{name} card step disagrees")
        del cpu_model, card_model, trainer
    torch.cuda.empty_cache()

    # 53. tw3profile: one step of each at beauty under the profiler ---------
    groups = {"GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90"),
              "copies (dtype casts: bdot's fp32 copies of bf16 graphs among them)": (
                  "copy",),
              "index kernels (gathers, their scatters, index_add_, sorts)": (
                  "index", "gather", "scatter", "sort", "radix"),
              "embedding_bag (fixed-order segment sums)": ("embedding_bag", "embeddingbag"),
              "FFT": ("fft", "regular_fft", "vector_fft"),
              "reductions (norms, sums, softmax, logsumexp)": ("reduce_kernel", "softmax",
                                                               "logsumexp"),
              "elementwise": ("elementwise",)}
    for name in TOWER3_MODELS:
        cfg, _ = path_config(name, args)
        model = build_model(cfg, ds, device)
        trainer = Trainer(model, ds, cfg)
        params = trainer.init_params()
        opt = trainer.make_optimizer(params)
        batch = first_batch(trainer, cfg)
        steps = []

        def step():
            steps.append(1)
            trainer.train_step(params, opt, batch)

        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        wall_ms, busy_ms = device_profile(
            "tw3profile", f"one {name} training step of {cfg.batch_size} edges at "
            f"{LINEAR_DATASET} (forward, backward, Adam)", step,
            os.path.join(args.out_dir, f"chip_smoke_{name.lower()}_step_profile.txt"),
            groups=groups)
        say("tw3profile", f"{name} step peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check_step_launches("tw3profile", model, len(steps))
        if name == "GUME":
            # bdot's backward casts the bf16 operand to a float32 copy: R (or
            # its transpose) once a product with R, the (I, I) I-I or kNN
            # graph once a product with it
            n_r = 2 * model.n_ui_layers + 1
            n_ii = model.n_ui_layers + 2 * model.n_layers
            r_ms = cuda_ms(lambda: model.r_norm.float(), 5)
            ii_ms = cuda_ms(lambda: model.ii_norm.float(), 5)
            copies_ms = n_r * r_ms + n_ii * ii_ms
            say("tw3profile", f"GUME's fp32 copies of its bf16 graphs in bdot's backward: "
                f"{n_r} of R {tuple(model.r_norm.shape)} at {r_ms:.3f} ms and {n_ii} of an "
                f"(I, I) graph at {ii_ms:.3f} ms, timed alone: {copies_ms:.2f} ms a step, "
                f"{100 * copies_ms / busy_ms:.1f}% of its device time ({busy_ms:.1f} ms), "
                f"{100 * copies_ms / wall_ms:.1f}% of its wall ({wall_ms:.1f} ms)")
        del model, trainer, params, opt
        torch.cuda.empty_cache()
    return time.perf_counter() - t_start


class UserGraphProbe:
    """While active, times each co-occurrence build
    (``graphs/user_graph.build_user_cooccurrence``; the device synchronized
    at both ends, its peak device memory above what was allocated before
    it) and each ``topk_sample`` (the host's neighbour draw, seconds)."""

    def __enter__(self):
        from chaorec_tpu_torch.graphs import user_graph

        self.ug = user_graph
        build, sample = self.orig = user_graph.build_user_cooccurrence, user_graph.topk_sample
        self.builds, self.samples = [], []

        def timed_build(*a, **kw):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = build(*a, **kw)
            torch.cuda.synchronize()
            self.builds.append(dict(seconds=time.perf_counter() - t0, peak_gib=(
                torch.cuda.max_memory_allocated() - base) / 2 ** 30))
            return out

        def timed_sample(*a, **kw):
            t0 = time.perf_counter()
            out = sample(*a, **kw)
            self.samples.append(time.perf_counter() - t0)
            return out

        user_graph.build_user_cooccurrence, user_graph.topk_sample = timed_build, timed_sample
        return self

    def __exit__(self, *exc):
        self.ug.build_user_cooccurrence, self.ug.topk_sample = self.orig


def towers4_phases(args, device, ds) -> float:
    """Phases 54-57: DualGNN and DRAGON (54), COHESION (55, its embeddings
    exported and served) and LightGT (56, its rank lists exported and
    served) through cli.run on beauty, each with its step's profile; the
    co-occurrence build on the card against the host's sparse path; then one
    step of each on the card against the CPU (57). No kernel launch expected
    anywhere. Returns their wall seconds."""
    from chaorec_tpu_torch.graphs.knn import ELLGraph
    from chaorec_tpu_torch.graphs.user_graph import build_user_cooccurrence
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.models.lightgt import LightGT
    from chaorec_tpu_torch.train.loop import Trainer

    t_start = time.perf_counter()
    groups = {"GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90"),
              "copies (dtype casts: bdot's fp32 copies of the bf16 R among them)": ("copy",),
              "index kernels (gathers, their scatters, index_add_, sorts)": (
                  "index", "gather", "scatter", "sort", "radix"),
              "reductions (norms, sums, softmax)": ("reduce_kernel", "softmax"),
              "elementwise": ("elementwise",)}
    host_uu = None
    real_resample = LightGT.resample_eval
    with tempfile.TemporaryDirectory() as tmp:
        for name in TOWER4_MODELS:
            phase = TOWER4_PHASE[name]
            cfg, _ = path_config(name, args)
            served = name in TOWER4_SERVED
            art = os.path.join(tmp, f"{name}.npz") if served else ""
            draws = []

            def counted(model):
                draws.append(model._eval_draws)
                real_resample(model)

            LightGT.resample_eval = counted
            try:
                with UserGraphProbe() as uu, BuildProbe() as built:
                    models, _ = linear_cli_run(phase, device, ds, name, cfg.replace(
                        num_epoch=TOWER4_EPOCHS, log_dir=args.out_dir, export_artifact=art),
                        first_combo(name)[1])
            finally:
                LightGT.resample_eval = real_resample
            model = models[0]
            check(model.device.type == device.type, f"{name} is not on the card")
            say(phase, f"{name} build: {built.builds[0]['seconds']:.3f} s")
            if uu.builds:
                b = uu.builds[0]
                say(phase, f"{name}'s user co-occurrence graph (B B^T of the {ds.num_user} x "
                    f"{ds.num_item} 0/1 matrix in bf16, {ds.num_user * ds.num_item * 2 / 1e6:.1f}"
                    f" MB, 4096-row chunks, each row's stable sort): {b['seconds']:.3f} s on "
                    f"the card, peak {b['peak_gib']:.3f} GiB above what was allocated before "
                    f"it; {model._uu[0].shape[1]} neighbours kept, {int(model._uu[2].sum())} in "
                    f"all; topk_sample (numpy, user by user) on the host "
                    + ", ".join(f"{s:.3f}" for s in uu.samples) + " s (construction, then "
                    "each epoch's pre_epoch)")
                if host_uu is None:
                    t0 = time.perf_counter()
                    host_uu = build_user_cooccurrence(ds.train_edges, ds.num_user, ds.num_item,
                                                      dense_threshold=0)
                    say(phase, f"the host's sparse path (scipy, dense_threshold 0): "
                        f"{time.perf_counter() - t0:.3f} s")
                same = all(np.array_equal(a, b) for a, b in zip(model._uu, host_uu))
                say(phase, f"{name}: the card's dense co-occurrence graph equals the host's "
                    f"sparse one (indices, counts, lengths): {same}")
                check(same, f"{name}: the card's co-occurrence graph differs from the host's")
            if name == "LightGT":
                say(phase, f"LightGT's evaluation subsets drawn at construction and before "
                    f"each of its {TOWER4_EPOCHS} ranking passes (draws {draws}); the export drew "
                    f"none (draw count {model._eval_draws})")
                check(draws == list(range(TOWER4_EPOCHS + 1))
                      and model._eval_draws == TOWER4_EPOCHS + 1,
                      f"LightGT's eval draws {draws}, count {model._eval_draws}")
            if art and name == "LightGT":
                reset_counts()
                rank_ids, hist_global = check_artifact(art, ds, "best-epoch")
                check_serving(phase, art, ds, device, rank_ids, hist_global, name)
                check(not any(other_counts()), f"{name} serving launched {other_counts()}")
            elif art:
                reset_counts()
                check_embeddings_serving(phase, art, ds, device, name)
                check(not any(other_counts()), f"{name} serving launched {other_counts()}")
            # one step at beauty under the profiler
            trainer = Trainer(model, ds, cfg)
            params = trainer.init_params()
            opt = trainer.make_optimizer(params)
            model.pre_epoch(params, 0)
            batch = first_batch(trainer, cfg)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            device_profile(phase, f"one {name} training step of {cfg.batch_size} edges at "
                           f"{LINEAR_DATASET} (forward, backward, Adam)",
                           lambda: trainer.train_step(params, opt, batch),
                           os.path.join(args.out_dir, f"chip_smoke_{name.lower()}_step_profile.txt"),
                           groups=groups)
            others = other_counts()
            say(phase, f"{name} step peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; kernel launches {others}")
            check(not any(others), f"{name} step launched {others}")
            del models, model, trainer, params, opt
            torch.cuda.empty_cache()

    # 57. tw4step: one step of each on the card against the CPU's -----------
    # on phase 32's seeded set with features, float32 U-I graph, equal params,
    # batch and draws (LightGT's sequences and keep masks), the CPU's kNN
    # graph, the card held to the CPU's side of each LeakyReLU; COHESION's
    # products are of bf16 operands on both sides: the bf16-operator bound
    sds = synthetic_dataset(LINEAR_DATASET, args.seed + 1, shape=STEP_SHAPE, features=True)
    for name in TOWER4_MODELS:
        cfg, _ = path_config(name, args)
        cfg = cfg.replace(graph_compute_dtype="float32")
        cpu_model, card_model = build_model(cfg, sds, "cpu"), build_model(cfg, sds, device)
        given = []
        if hasattr(cpu_model, "_uu"):
            same = (all(np.array_equal(a, b) for a, b in zip(card_model._uu, cpu_model._uu))
                    and torch.equal(card_model.user_nbr_idx.cpu(), cpu_model.user_nbr_idx))
            check(same, f"{name}: the card built another user graph than the CPU")
            given.append("the same user graph (built on each)")
        if hasattr(cpu_model, "mm_graph"):
            knn_rows = int((card_model.mm_graph.indices.cpu() != cpu_model.mm_graph.indices)
                           .any(1).sum())
            card_model.mm_graph = ELLGraph(cpu_model.mm_graph.indices.to(device),
                                           cpu_model.mm_graph.weights.to(device))
            given.append(f"the CPU's kNN graph (rows the card's own build picked otherwise: "
                         f"{knn_rows})")
        trainer = Trainer(cpu_model, sds, cfg)
        params = trainer.init_params()
        batch = first_batch(trainer, cfg)
        draws = cpu_model.draws(trainer.generator, batch) if hasattr(cpu_model, "draws") else None
        rtol = BF16_STEP_RTOL if name == "COHESION" else STEP_RTOL
        kinks, cuts = Kinks(), Cuts()
        c_loss, c_grads, _ = device_step(cpu_model, params, None, batch, draws,
                                         pinned_sides(kinks.record(), cuts.record()))
        reset_counts()
        g_loss, g_grads, _ = device_step(card_model, params, None, batch, draws,
                                         pinned_sides(kinks.replay(), cuts.replay()))
        worst, loss_rel, others = worst_share(g_grads, c_grads, rtol), abs(
            g_loss - c_loss) / abs(c_loss), other_counts()
        # not a gate: how far the CPU's own step moves from params nudged by
        # 2^-24 of each entry, on the same kink sides
        nudge_gen = torch.Generator().manual_seed(57)
        nudged = {k: v.detach() * (1 + 2.0 ** -24 * torch.randn(v.shape, generator=nudge_gen))
                  for k, v in params.items()}
        _, n_grads, _ = device_step(cpu_model, nudged, None, batch, draws,
                                    pinned_sides(kinks.replay(), cuts.replay()))
        spread = worst_share(n_grads, c_grads, rtol)
        say("tw4step", f"one {name} step of {batch.users.shape[0]} edges on a float32 R "
            f"({sds.num_user} x {sds.num_item}, dim {cfg.dim_E}, 4096- and 384-wide features"
            f"{', products of bf16 operands' if name == 'COHESION' else ''}), card vs CPU on "
            f"the same params, batch, negatives{', draws' if draws else ''}"
            f"{''.join(', ' + g for g in given)}: loss {g_loss:.7f} vs {c_loss:.7f} (rel "
            f"{loss_rel:.2e}, bound {STEP_LOSS_RTOL:g}); worst gradient {worst[1]} at "
            f"{worst[0]:.3f} of its bound (rtol {rtol:g}; the CPU's own step from params "
            f"nudged by 2^-24: {spread[1]} at {spread[0]:.3f}, not a gate); LeakyReLU units on "
            f"the other side {kinks.flips}; kernel launches {others}")
        check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0 and not any(others),
              f"{name} card step disagrees")
        del cpu_model, card_model, trainer
    torch.cuda.empty_cache()
    return time.perf_counter() - t_start


class KnnPins:
    """The neighbours of each kNN graph a step builds (``graphs/knn.knn_topk``
    as LATTICE's and MICRO's batch 0 call it) and the kept entries of each
    dense similarity (``models/lattice.dense_knn_sim``: every entry at least
    the row's k-th), recorded on one step and held to on another, as
    ``Cuts`` holds the cuts: two devices whose float32 similarities differ
    by an ulp can pick another k-th neighbour where two nearly tie.
    ``replay()`` gathers each row's similarities at the recorded neighbours
    (differentiable, as top-k's values are), or keeps the recorded entries;
    ``flips`` counts the rows whose own choice differs."""

    def __init__(self):
        self.picks, self.flips, self._next = [], 0, 0

    @contextlib.contextmanager
    def _patched(self, mode):
        from chaorec_tpu_torch.models import lattice, micro

        topk, dense = lattice.knn_topk, lattice.dense_knn_sim
        self.flips, self._next = 0, 0
        if mode == "record":
            self.picks = []

        def pinned(own, replayed):
            if mode == "record":
                self.picks.append(own.detach().cpu())
                return None
            rec = self.picks[self._next].to(own.device)
            self._next += 1
            same = (torch.sort(own, 1).values == torch.sort(rec, 1).values
                    if own.dtype != torch.bool else own == rec)
            self.flips += int((~same).any(1).sum())
            return replayed(rec)

        def pinned_topk(features, k, row_chunk=4096):
            vals, idx = topk(features, k, row_chunk)
            f = features / torch.clamp(torch.linalg.vector_norm(features, dim=1, keepdim=True),
                                       min=1e-12)
            f = f.to(torch.float32)
            out = pinned(idx, lambda rec: ((f @ f.t()).gather(1, rec), rec))
            return (vals, idx) if out is None else out

        def pinned_dense(feats, k):
            f = lattice.l2norm(feats)
            sim = f @ f.t()
            kept = sim >= torch.topk(sim, k, dim=1).values[:, -1:]
            out = pinned(kept, lambda rec: torch.where(rec, sim, torch.zeros_like(sim)))
            return dense(feats, k) if out is None else out

        lattice.knn_topk = micro.knn_topk = pinned_topk
        lattice.dense_knn_sim = pinned_dense
        try:
            yield self
        finally:
            lattice.knn_topk = micro.knn_topk = topk
            lattice.dense_knn_sim = dense
        check(mode == "record" or self._next == len(self.picks),
              f"a step built {self._next} kNN graphs, its record {len(self.picks)}")

    def record(self):
        return self._patched("record")

    def replay(self):
        return self._patched("replay")


def epoch_batches(trainer, cfg, n: int):
    """The first ``n`` batches of an epoch as the trainer makes them (each
    ``index`` its position), completed by ``bpr_batch``."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches

    return [trainer.bpr_batch(b) for b in
            make_edge_batches(trainer.generator, trainer.edges, cfg.batch_size)[:n]]


def graph_bytes(graph) -> str:
    return ", ".join(f"{tuple(t.shape)} {str(t.dtype).replace('torch.', '')} "
                     f"{t.numel() * t.element_size() / 1e6:.1f} MB" for t in leaves_of(graph))


def rebuild_card_vs_cpu(name, cfg, sds, device) -> dict:
    """Phase 61 for LATTICE or MICRO: batch 0 (the graph build, gradients
    into the gated params) and batch 1 (on the CPU's batch-0 graph, read
    detached) on the CPU and on the card from the same params and batches,
    the card on the CPU's side of every kNN choice (``KnnPins``: the
    learned graphs' neighbours and the originals built at construction,
    the CPU's). Returns {batch: (loss rel, worst gradient share, name,
    graph worst share or None, K2 launches, kNN rows flipped)}."""
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.params import clone_to
    from chaorec_tpu_torch.train.loop import Trainer

    cpu_model, card_model = build_model(cfg, sds, "cpu"), build_model(cfg, sds, device)
    for attr in ("image_original", "text_original"):  # built at construction: the CPU's
        setattr(card_model, attr, clone_to(getattr(cpu_model, attr), device))
    trainer = Trainer(cpu_model, sds, cfg)
    params = trainer.init_params()
    batches = epoch_batches(trainer, cfg, 2)
    rtol = BF16_STEP_RTOL if cfg.graph_compute_dtype == "bfloat16" else STEP_RTOL
    out, state = {}, cpu_model.init_state()
    for batch in batches:
        pins = KnnPins()
        c_loss, c_grads, c_state = device_step(cpu_model, params, state, batch, None,
                                               pins.record(), flat=False)
        reset_counts()
        g_loss, g_grads, g_state = device_step(card_model, params, state, batch, None,
                                               pins.replay(), flat=False)
        k2 = lse_counts()
        check_step_launches("rgstep", card_model, 1, *kernel_wrappers()[3:6])
        worst = worst_share(g_grads, c_grads, rtol)
        gated = max(g.abs().max().item() for k, g in g_grads.items()
                    if k in cpu_model.epoch0_params)
        check((gated > 0) == (batch.index == 0),
              f"{name} batch {batch.index}: the gated params' gradient is {gated}")
        graph = None
        if batch.index == 0:  # the built graph: the same neighbours, values to the step bound
            cg, gg = leaves_of(c_state), [t.cpu() for t in leaves_of(g_state)]
            check(all(torch.equal(a, b) for a, b in zip(gg, cg) if not a.is_floating_point()),
                  f"{name}: the card's graph has other neighbours")
            graph = max(((a.float() - b.float()).abs().max().item()
                         / (rtol * b.float().abs().max().item() + 1e-30))
                        for a, b in zip(gg, cg) if a.is_floating_point())
            state = c_state  # batch 1 reads the CPU's graph on both devices
        out[batch.index] = (abs(g_loss - c_loss) / abs(c_loss), worst[0], worst[1], graph, k2,
                            pins.flips)
    return out


def mmssl_card_vs_cpu(cfg, sds, device) -> dict:
    """Phase 61 for MMSSL: MMSSL_STEP_BATCHES batches of ``mmssl_step`` on
    the CPU and on the card, on the same batches and draws, each optimizer
    step of the card's ("d": the discriminator's Adam, "main": the AdamW)
    from the CPU's params and optimizer state before it, each batch from
    the CPU's model state. Each gradient is held within the larger of the
    step bounds and SPREAD_FACTOR times its spread (the CPU's step from
    inputs nudged by 2^-24: the biases before the batch norms have a zero
    gradient in exact arithmetic, and each device's is rounding noise);
    the card's params and moments after each step against the float64 step
    of the CPU's inputs with the card's own gradient (ADAM_STEP_RTOL of the
    tensor's largest entry); the new count matrices and buffer users equal.
    Returns {loss, grad, adam (worst shares), off (entries the steps left
    more than STEP_RTOL of the tensor's max from the CPU's: a gradient within
    rounding of 0, counted), buf_rows (top-item rows the card picked
    otherwise; k_top 0 leaves them unused), steps, launches}."""
    from chaorec_tpu_torch.models import build_model, mmssl
    from chaorec_tpu_torch.params import clone_to
    from chaorec_tpu_torch.train.loop import deterministic_mode

    cpu_model = build_model(cfg, sds, "cpu")
    models = {"cpu": cpu_model, "card": build_model(cfg, sds, device), "nudged": cpu_model}
    fams = {k: m.trainer_cls(m, sds, cfg) for k, m in models.items()}
    base = fams["cpu"]._base
    params = {"cpu": base.init_params()}
    for side in ("card", "nudged"):
        params[side] = {k: v.detach().to(models[side].device, copy=True).requires_grad_()
                        for k, v in params["cpu"].items()}
    opts = {k: (f.make_optimizer(params[k]), *f.gen_opts) for k, f in fams.items()}
    hyper = {"d": (mmssl.MMSSLTrainer.D_LR, mmssl.MMSSLTrainer.D_BETAS, 0.0),
             "main": (float(cfg.learning_rate), (0.9, 0.999), mmssl.MMSSLTrainer.WEIGHT_DECAY)}
    index = {"main": 0, "d": 1}
    nudge_gen = torch.Generator().manual_seed(61)

    def names_of(side, j):
        mine = {id(p) for grp in opts[side][j].param_groups for p in grp["params"]}
        return [k for k, p in params[side].items() if id(p) in mine]

    def set_side(side, inputs, states):
        on = models[side].device
        with torch.no_grad():
            for k, p in params[side].items():
                x = inputs[k]
                if side == "nudged":
                    x = x * (1 + 2.0 ** -24 * torch.randn(x.shape, generator=nudge_gen))
                p.copy_(x)
        for j, st in states.items():
            for k, (step, m, v) in st.items():
                if step or opts[side][j].state.get(params[side][k]):
                    set_adam_state(opts[side][j], params[side][k], step, m.to(on), v.to(on))

    out = dict(loss=0.0, grad=(0.0, ""), adam=(0.0, ""), off=0, buf_rows=0, steps=[],
               launches=0)
    batches = epoch_batches(base, cfg, MMSSL_STEP_BATCHES)
    mstate = cpu_model.init_state()
    for batch in batches:
        draws = cpu_model.draws(base.generator, batch)
        start_params = {k: p.detach().clone() for k, p in params["cpu"].items()}
        start_states = {j: {k: adam_state(o, params["cpu"][k]) for k in names_of("cpu", j)}
                        for j, o in enumerate(opts["cpu"])}
        rec, losses, states = {}, {}, {}

        def hook(side):
            def on_step(label):
                j = index[label]
                mine = names_of(side, j)
                rec[side].append(dict(
                    label=label, names=mine,
                    params={k: p.detach().cpu().clone() for k, p in params[side].items()},
                    grads={k: params[side][k].grad.detach().cpu().clone() for k in mine},
                    state={k: adam_state(opts[side][j], params[side][k]) for k in mine}))
                if side != "cpu":  # the next optimizer step from the CPU's inputs
                    cpu = rec["cpu"][len(rec[side]) - 1]
                    set_side(side, cpu["params"], {j: cpu["state"]})
            return on_step

        for side in models:
            on = models[side].device
            rec[side] = []
            if side != "cpu":
                set_side(side, start_params, start_states)
            reset_counts()
            with deterministic_mode():
                loss, states[side] = mmssl.mmssl_step(
                    models[side], opts[side], params[side], clone_to(mstate, on),
                    batch_to(batch, on), clone_to(draws, on), on_step=hook(side))
                losses[side] = loss.item()
            if side == "card":
                out["launches"] += sum(other_counts())
        out["steps"] = [e["label"] for e in rec["cpu"]]
        check(all([e["label"] for e in rec[s]] == ["d", "main"] for s in rec),
              f"MMSSL's optimizer steps ran {[e['label'] for e in rec['card']]}")
        out["loss"] = max(out["loss"], abs(losses["card"] - losses["cpu"]) / max(
            STEP_LOSS_RTOL * abs(losses["cpu"]),
            SPREAD_FACTOR * abs(losses["nudged"] - losses["cpu"])))
        done = {j: dict(s) for j, s in start_states.items()}
        for i, c in enumerate(rec["cpu"]):
            g = rec["card"][i]
            j = index[c["label"]]
            lr, betas, wd = hyper[c["label"]]
            inputs = start_params if i == 0 else rec["cpu"][i - 1]["params"]
            scale = max(w.abs().max().item() for w in c["grads"].values())
            for k, want in c["grads"].items():
                base_tol = STEP_RTOL * want.abs().max().item() + STEP_ATOL * scale
                drift = (rec["nudged"][i]["grads"][k] - want).abs().max().item()
                out["grad"] = max(out["grad"], ((g["grads"][k] - want).abs().max().item()
                                                / max(base_tol, SPREAD_FACTOR * drift),
                                                f"{k} of {c['label']}"))
            for k in c["names"]:
                step, m0, v0 = done[j][k]
                p, m, v = adam_reference(inputs[k], m0, v0, step, g["grads"][k], lr, 1e-8,
                                         betas, wd)
                check(g["state"][k][0] == step + 1 == c["state"][k][0],
                      f"MMSSL {c['label']}: {k}'s step count")
                for what, got, want in (("", g["params"][k], p),
                                        (" first moment", g["state"][k][1], m),
                                        (" second moment", g["state"][k][2], v)):
                    err = (got.double() - want).abs().max().item()
                    share = err / (ADAM_STEP_RTOL * want.abs().max().item() + 1e-30)
                    out["adam"] = max(out["adam"], (share, f"{k}{what} after {c['label']}"))
                bound = STEP_RTOL * c["params"][k].abs().max().item() + STEP_ATOL
                out["off"] += int(((g["params"][k] - c["params"][k]).abs() > bound).sum())
            for k in set(inputs) - set(c["names"]):  # the other params did not move
                check(torch.equal(g["params"][k], inputs[k]),
                      f"MMSSL {c['label']} moved {k}, not its optimizer's")
            done[j] = c["state"]
        cs, gs = states["cpu"], {k: v.cpu() for k, v in states["card"].items()}
        for k in ("image_cnt", "text_cnt", "buf_users", "buf_valid"):
            check(torch.equal(gs[k], cs[k]), f"MMSSL batch {batch.index}: the card's {k} differs")
        out["buf_rows"] += int(sum((gs[k] != cs[k]).any(1).sum() for k in ("buf_image",
                                                                             "buf_text")))
        mstate = cs
        for side in ("card", "nudged"):  # each side's copies end as the CPU's
            set_side(side, params["cpu"], {})
    return out


def micro_lse_phase(gen, device, ds, tau: float) -> dict:
    """K2 at MICRO's shape on ``ds``: q the I unit rows of a modal view over
    tau, k those rows and the I rows of the fused view ([n1; n2], 2I rows),
    so that dq and dk both reach n1; the forward, and the gradients of n1
    (dq + dk) and n2 (dk) through autograd, against the plain version under
    phase 3's gates; then each kernel's time beside the plain version's, the
    library route's and its bound. Returns {"max_abs_err": {kernel: err},
    "micro": {kernel: timing}}."""
    from chaorec_tpu_torch.ops.losses import catalog_logsumexp

    n, e = ds.num_item, 64
    n1, n2 = (torch.nn.functional.normalize(torch.randn(n, e, generator=gen, device=device),
                                            dim=1).requires_grad_() for _ in range(2))
    g = torch.randn(n, generator=gen, device=device)

    def run():
        out = catalog_logsumexp(n1, torch.cat([n1, n2]), tau)
        return out, torch.autograd.grad(out, (n1, n2), g)

    before = lse_counts()
    got, grads = run()
    torch.cuda.synchronize()
    launched = tuple(a - c for a, c in zip(lse_counts(), before))
    with plain_logsumexp():
        want, wgrads = run()
    share = tol_share(got, want, **LSE_TOL)
    rel_tol = LSE_BWD_REL_TOL * max(1.0, 0.1 / tau)
    errs = {"fwd": (got - want).abs().max().item()}
    rels = []
    for what, a, w in zip(("dq+dk (n1)", "dk (n2)"), grads, wgrads):
        err = (a - w).abs().max().item()
        errs["dk"] = max(errs.get("dk", 0.0), err)
        if what.startswith("dq"):
            errs["dq"] = err
        rels.append((what, err / w.abs().max().item()))
    say("k2micro", f"catalog_logsumexp at MICRO's shape ({n}, {2 * n}, {e}), temperature {tau}, "
        f"q rows of k: launches fwd/dq/dk {launched}; fwd max abs err {errs['fwd']:.3e} "
        f"({share:.3f} of rtol/atol 1e-5); " + ", ".join(
            f"{w} max abs err / max |plain| {r:.2e}" for w, r in rels)
        + f" (bound {rel_tol:g})")
    check(launched == (1, 1, 1) and share <= 1.0 and max(r for _, r in rels) <= rel_tol,
          "K2 at MICRO's shape disagrees")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q, k = (n1 / tau).detach(), torch.cat([n1, n2]).detach()
    results = {"max_abs_err": errs, "micro": lse_timings("k2micro", "micro", q, k, g, True, sms)}
    del n1, n2, q, k, got, grads, want, wgrads
    torch.cuda.empty_cache()
    return results


def rebuild_phases(args, device, ds) -> tuple:
    """Phases 58-61: LATTICE's and MICRO's CLI runs on beauty (58; MICRO's
    K2 launches counted; both exports served), each one's batch-0 build
    (seconds, peak memory) and the profiles of a batch-0 step and of a
    frozen step; MMSSL's CLI run through its trainer (59; the export
    skipped) and its step's profile; K2 at MICRO's shape (60); batch 0 and
    a frozen batch of LATTICE and MICRO, and MMSSL's two optimizer steps
    over two batches, on the card against the CPU (61). Returns (their wall
    seconds, K2's launches of MICRO's CLI run, K2's results at MICRO's
    shape)."""
    from chaorec_tpu_torch.models.mmssl import MMSSLTrainer
    from chaorec_tpu_torch.train.loop import Trainer

    t_start = time.perf_counter()
    groups = {"K2 (streaming logsumexp)": ("lse_",),
              "GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90"),
              "copies (dtype casts)": ("copy",),
              "top-k and sorts (the graph build)": ("topk", "sort", "radix", "bitonic"),
              "index kernels (gathers, their scatters, index_add_)": (
                  "index", "gather", "scatter"),
              "reductions (norms, sums, softmax)": ("reduce_kernel", "softmax"),
              "elementwise": ("elementwise",)}
    # 58. rebuild: cli.run of LATTICE and MICRO, exports served ---------------
    k2_run = (0, 0, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name in REBUILD_MODELS:
            cfg, _ = path_config(name, args)
            art = os.path.join(tmp, f"{name}.npz")
            terms = MICRO_TERMS if (name == "MICRO"
                                    and cfg.graph_compute_dtype == "bfloat16") else 0
            with BuildProbe() as built:
                models, _ = linear_cli_run("rebuild", device, ds, name, cfg.replace(
                    num_epoch=REBUILD_EPOCHS, log_dir=args.out_dir, export_artifact=art),
                    first_combo(name)[1], lse_terms=terms)
            if name == "MICRO":
                k2_run = lse_counts()
            model = models[0]
            check(model.device.type == device.type, f"{name} is not on the card")
            b = built.builds[0]
            if name == "LATTICE":
                rows = [t for t in (model._rt, model._rrt, model._rtr) if t is not None]
                ui = (f"dense {model.graph.dense_r.dtype}" if model.graph.use_dense
                      else "sparse")
                layout = (f"U-I graph {ui}; "
                          f"item graph {'dense bf16' if model.dense_items else '(vals, idx)'}; "
                          f"row operators R^T, R R^T, R^T R: {graph_bytes(rows) or 'none'}")
            else:
                layout = (f"U-I graph sparse; modal graphs (vals, idx); full-catalog InfoNCE "
                          f"{'through K2' if model.cl_fast else 'direct'}")
            say("rebuild", f"{name} build: {b['seconds']:.3f} s, peak device memory "
                f"{b['peak_gib']:.3f} GiB above what was allocated before it; {layout}")
            reset_counts()
            check_embeddings_serving("rebuild", art, ds, device, name)
            check(not any(other_counts()), f"{name} serving launched {other_counts()}")
            # the batch-0 build alone, then a batch-0 step and a frozen step
            trainer = Trainer(model, ds, cfg)
            params = trainer.init_params()
            opt = trainer.make_optimizer(params)
            build = model._build_item_adj if name == "LATTICE" else model._build_adjs
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.no_grad():
                graph = build(params)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            say("rebuild", f"{name}'s batch-0 graph build alone (no gradient): {build_s:.3f} s, "
                f"peak {peak:.3f} GiB above what was allocated before it; the carried state "
                f"{graph_bytes(graph)}")
            del graph
            for batch in epoch_batches(trainer, cfg, 2):
                what = "batch 0 (the graph build)" if batch.index == 0 else "a frozen batch"
                steps = []

                def step():
                    steps.append(1)
                    trainer.train_step(params, opt, batch)

                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                device_profile("rebuild", f"one {name} training step on {what}, "
                               f"{cfg.batch_size} edges at {LINEAR_DATASET} (forward, backward, "
                               "Adam over every param)", step,
                               os.path.join(args.out_dir, f"chip_smoke_{name.lower()}_step"
                                            f"{batch.index}_profile.txt"), groups=groups)
                k2 = lse_counts()
                expected = (len(steps) * terms,) * 3
                say("rebuild", f"{name} step on {what}: peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K2 fwd/dq/dk "
                    f"launches {k2} (expected {expected}: {len(steps)} steps)")
                check(k2 == expected, f"{name} step launched K2 {k2}")
                check_step_launches("rebuild", model, len(steps), *kernel_wrappers()[3:6])
            del models, model, trainer, params, opt
            torch.cuda.empty_cache()

    # 59. mmssl: cli.run through MMSSLTrainer, the export skipped ------------
    with tempfile.TemporaryDirectory() as tmp:
        cfg, _ = path_config(MMSSL_MODEL, args)
        run_cfg = cfg.replace(num_epoch=REBUILD_EPOCHS, log_dir=args.out_dir,
                              export_artifact=os.path.join(tmp, f"{MMSSL_MODEL}.npz"))
        models, _ = linear_cli_run("mmssl", device, ds, MMSSL_MODEL, run_cfg,
                                   first_combo(MMSSL_MODEL)[1])
        check_export_skipped("mmssl", MMSSL_MODEL, run_cfg)
    model = models[0]
    check(model.device.type == device.type and model.trainer_cls is MMSSLTrainer,
          "MMSSL is not on the card through its trainer")
    say("mmssl", f"MMSSL's dense tables: raw_ui, ui_graph, iu_graph "
        f"{graph_bytes((model.raw_ui, model.ui_graph, model.iu_graph))}; k_top {model.k_top} "
        f"(every rebuild gives zero count matrices at 0); discriminator widths "
        f"{model.num_item} -> {model.d_widths[0]} -> {model.d_widths[1]} -> 1")
    family = MMSSLTrainer(model, ds, cfg)
    params = family._base.init_params()
    opt = family._base.make_optimizer(params)
    batch = first_batch(family._base, cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    device_profile("mmssl", f"one MMSSL training step of {cfg.batch_size} edges at "
                   f"{LINEAR_DATASET} (the discriminator's loss with its gradient penalty and "
                   "Adam step, then the generator loss and the AdamW step)",
                   lambda: family.train_step(params, opt, batch),
                   os.path.join(args.out_dir, "chip_smoke_mmssl_step_profile.txt"), groups=groups)
    say("mmssl", f"MMSSL step peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB; kernel launches {other_counts()}")
    check(not any(other_counts()), f"MMSSL step launched {other_counts()}")
    del models, model, family, params, opt
    torch.cuda.empty_cache()

    # 60. k2micro: K2 at MICRO's shape ---------------------------------------
    gen = torch.Generator(device=device).manual_seed(args.seed + 60)
    k2micro = micro_lse_phase(gen, device, ds, first_combo("MICRO")[0]["ssl_temp"])

    # 61. rgstep: the card against the CPU on phase 32's seeded set -----------
    sds = synthetic_dataset(LINEAR_DATASET, args.seed + 1, shape=STEP_SHAPE, features=True)
    for name in REBUILD_MODELS:
        for dtype in ("float32", "bfloat16"):
            cfg, _ = path_config(name, args)
            cfg = cfg.replace(graph_compute_dtype=dtype)
            r = rebuild_card_vs_cpu(name, cfg, sds, device)
            rtol = BF16_STEP_RTOL if dtype == "bfloat16" else STEP_RTOL
            loss_tol = BF16_LOSS_RTOL if dtype == "bfloat16" else STEP_LOSS_RTOL
            terms = MICRO_TERMS if name == "MICRO" and dtype == "bfloat16" else 0
            for index, (loss_rel, worst, where, graph, k2, flips) in r.items():
                what = ("batch 0 (the graph build)" if index == 0
                        else "batch 1 (the CPU's batch-0 graph, detached)")
                say("rgstep", f"{name} at {dtype}, {what}, {cfg.batch_size} edges "
                    f"({sds.num_user} x {sds.num_item}, dim {cfg.dim_E}, 4096- and 384-wide "
                    f"features), card vs CPU on the same params and batch, the CPU's original "
                    f"graphs and kNN picks (rows the card's own picks differ: {flips}): loss rel "
                    f"{loss_rel:.2e} (bound {loss_tol:g}); "
                    f"worst gradient {where} at {worst:.3f} of its bound (rtol {rtol:g})"
                    + ("" if graph is None else f"; the built graph at {graph:.3f} of its bound")
                    + f"; K2 fwd/dq/dk launches {k2} (expected {(terms,) * 3})")
                check(loss_rel <= loss_tol and worst <= 1.0 and (graph is None or graph <= 1.0)
                      and k2 == (terms,) * 3, f"{name} at {dtype} card step disagrees")
            torch.cuda.empty_cache()
    cfg, _ = path_config(MMSSL_MODEL, args)
    r = mmssl_card_vs_cpu(cfg.replace(graph_compute_dtype="float32"), sds, device)
    say("rgstep", f"MMSSL, {MMSSL_STEP_BATCHES} batches of {cfg.batch_size} edges "
        f"({sds.num_user} x {sds.num_item}, dim {cfg.dim_E}), each optimizer step "
        f"({', '.join(r['steps'])}) of the card's from the CPU's params and state, same batch, "
        f"draws and model state: worst loss at {r['loss']:.3f} of its bound, worst gradient "
        f"{r['grad'][1]} at {r['grad'][0]:.3f} of its bound (the larger of the step bounds and "
        f"{SPREAD_FACTOR:g} x its spread from inputs nudged by 2^-24); the card's steps against "
        f"float64 Adam and AdamW on its own gradient: worst {r['adam'][1]} at {r['adam'][0]:.3f} "
        f"of {ADAM_STEP_RTOL:g} of the tensor's max; entries the steps left more than "
        f"{STEP_RTOL:g} of the tensor's max from the CPU's (a gradient within rounding of 0) "
        f"{r['off']}; count matrices and buffer users equal, top-item rows picked otherwise "
        f"{r['buf_rows']} (unused at k_top 0); kernel launches {r['launches']}")
    check(r["loss"] <= 1.0 and r["grad"][0] <= 1.0 and r["adam"][0] <= 1.0
          and not r["launches"], "MMSSL card steps disagree")
    torch.cuda.empty_cache()
    return time.perf_counter() - t_start, k2_run, k2micro


class PhaseTimer:
    """While active, the seconds of the diffusion family's epoch phases, the
    device synchronized at both ends of each: A (each denoiser epoch), B
    (each rebuild), C (each BPR epoch), summed over the calls; and the
    device's running peak memory at the end of each (``peak_gib``, the
    latest call's: the phase where it rises set it)."""

    def __enter__(self):
        from chaorec_tpu_torch.models import diffmm, mhrec

        self.seconds = {"A": 0.0, "B": 0.0, "C": 0.0}
        self.peak_gib = {}
        self.patched = [(diffmm.DiffusionFamilyTrainer, "denoise_epoch", "A"),
                        (diffmm.DiffMM, "rebuild_graphs", "B"),
                        (mhrec.MHRec, "rebuild_incidence", "B"),
                        (diffmm.DiffusionFamilyTrainer, "bpr_epoch", "C")]
        self.orig = [getattr(cls, n) for cls, n, _ in self.patched]
        for (cls, n, ph), fn in zip(self.patched, self.orig):
            setattr(cls, n, self._timed(fn, ph))
        return self

    def _timed(self, fn, ph):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds[ph] += time.perf_counter() - t0
            self.peak_gib[ph] = torch.cuda.max_memory_allocated() / 2 ** 30
            return out
        return timed

    def __exit__(self, *exc):
        for (cls, n, _), fn in zip(self.patched, self.orig):
            setattr(cls, n, fn)


class K4Dtypes:
    """While active, the segment sums' calls of ``prefix_cumsum`` (one K4
    launch each on the card) by input dtype, through a pass-through around
    ``ops/ell.prefix_cumsum``."""

    def __enter__(self):
        from chaorec_tpu_torch.ops import ell

        self.ell, self.orig, self.counts = ell, ell.prefix_cumsum, {}

        def tallied(v, out=None):
            key = str(v.dtype).replace("torch.", "")
            self.counts[key] = self.counts.get(key, 0) + 1
            return self.orig(v, out=out)

        ell.prefix_cumsum = tallied
        return self

    def __exit__(self, *exc):
        self.ell.prefix_cumsum = self.orig


def mhrec_k4_steps(cfg) -> int:
    """K4 launches of one MHRec training step: per hypergraph layer and
    modality, ``seg_edge_weighted_sum``'s forward (fp32 input) and the
    backward of ``seg_gather`` (its input at the slot rows' dtype)."""
    return 2 * 2 * cfg.h_layers


def diffusion_lse_phase(gen, device, ds, tau: float) -> dict:
    """K2 at the diffusion family's two contrast shapes on ``ds``: 1024 unit
    rows of one table over tau (q, gathered) against the U or I unit rows
    of another (k), both with gradient; the forward, dq and dk against the
    plain version and its autograd under phase 3's gates, then each kernel's
    time beside the plain version's, the library route's and its bound.
    Returns {"max_abs_err": {kernel: err}, "user": {kernel: timing}, "item": ...}."""
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_logsumexp,
                                                     streaming_logsumexp_reference)

    errs = {"fwd": 0.0, "dq": 0.0, "dk": 0.0}
    results = {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for side, n in (("user", ds.num_user), ("item", ds.num_item)):
        shape = (1024, n, 64, tau, True)
        q, k, g = lse_inputs(gen, shape, device)
        before = lse_counts()
        got = streaming_logsumexp(q, k)
        grads = torch.autograd.grad(got, (q, k), g)
        torch.cuda.synchronize()
        launched = tuple(a - c for a, c in zip(lse_counts(), before))
        want = streaming_logsumexp_reference(q, k)
        wgrads = torch.autograd.grad(want, (q, k), g)
        share = tol_share(got, want, **LSE_TOL)
        errs["fwd"] = max(errs["fwd"], (got - want).abs().max().item())
        rel_tol = LSE_BWD_REL_TOL * max(1.0, 0.1 / tau)
        rels = []
        for kernel, a, w in zip(("dq", "dk"), grads, wgrads):
            err = (a - w).abs().max().item()
            errs[kernel] = max(errs[kernel], err)
            rels.append(err / w.abs().max().item())
        say("k2diff", f"catalog_logsumexp at the diffusion family's {side} shape (1024, {n}, 64), "
            f"temperature {tau}, q and k from two tables: launches fwd/dq/dk {launched}; fwd max "
            f"abs err {(got - want).abs().max().item():.3e} ({share:.3f} of rtol/atol 1e-5); "
            f"dq, dk max abs err / max |plain| {rels[0]:.2e}, {rels[1]:.2e} (bound {rel_tol:g})")
        check(launched == (1, 1, 1) and share <= 1.0 and max(rels) <= rel_tol,
              f"K2 at the diffusion family's {side} shape disagrees")
        results[side] = lse_timings("k2diff", side, q.detach(), k.detach(), g, True, sms)
        del q, k, g, got, grads, want, wgrads
        torch.cuda.empty_cache()
    results["max_abs_err"] = errs
    return results


def mhrec_scan_phase(gen, device, cfg, ds) -> dict:
    """K4 at MHRec's shape on ``ds`` (He x num_hypernodes slots, one
    hyperedge a train edge, by dim_E): fp32 input (``seg_edge_weighted_sum``'s
    forward) and bf16 input (``seg_gather``'s backward at bf16 slot rows)
    against prefix_cumsum_reference and a float64 prefix under phase 20's
    gate, the same bits twice, and their times; then ``seg_edge_weighted_sum``
    at that shape on the card (random incidence over the U + I nodes and
    the sentinel, exp weights, N(0, 1) edge rows) against its float64 plain
    sum, within twice the prefix gate (a difference of two prefixes). Returns
    {"fp32": timing, "bf16": timing, "max_abs_err": {dtype: err}, "shape": (M, D)}."""
    from chaorec_tpu_torch.ops.ell import build_segment_transpose, seg_edge_weighted_sum
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum

    k, d = min(int(cfg.num_hypernodes), ds.num_user + ds.num_item), cfg.dim_E
    he, n_nodes = ds.num_edges, ds.num_user + ds.num_item
    m = he * k
    out = {"shape": (m, d), "max_abs_err": {}}
    for key, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        out["max_abs_err"][key] = k4_hold("k4mh", gen, device, (m, d), dtype)
        out[key] = k4_times("k4mh", gen, device, f"mhrec[{key}]", m, d, dtype)
    h = torch.randint(0, n_nodes + 1, (he, k), generator=gen, device=device)
    edge = torch.randn((he, d), generator=gen, device=device)
    alpha = torch.exp(0.5 * torch.randn(m, generator=gen, device=device))
    flat = h.reshape(-1)
    perm, ptr = build_segment_transpose(flat, n_nodes + 1)
    before = prefix_cumsum.launches
    got = seg_edge_weighted_sum(edge, alpha, flat, perm, perm // k, ptr)
    torch.cuda.synchronize()
    msgs = alpha.double()[:, None] * edge.double().repeat_interleave(k, 0)
    exact = torch.zeros((n_nodes + 1, d), dtype=torch.float64, device=device).index_add_(
        0, flat, msgs)
    prefix = torch.cumsum(msgs[perm], 0)
    atol = 2 * scan_atol(prefix, m)
    err = (got.double() - exact).abs().max().item()
    say("k4mh", f"seg_edge_weighted_sum ({he} hyperedges x {k} slots over {n_nodes} nodes and "
        f"the sentinel, D {d}): {prefix_cumsum.launches - before} K4 launch, max abs err vs "
        f"float64 {err:.3e} (bound {atol:.3e}: twice the prefix gate of its running total)")
    check(prefix_cumsum.launches == before + 1 and err <= atol,
          "seg_edge_weighted_sum disagrees with its float64 sum")
    del h, edge, alpha, msgs, exact, prefix, got
    torch.cuda.empty_cache()
    return out


def diffusion_card_vs_cpu(name, cfg, sds, device) -> dict:
    """Phase 66 for DiffMM or MHRec on the seeded set ``sds`` at a float32
    graph: DIFFUSION_STEP_BATCHES phase-A steps of each denoiser Adam, the
    CPU's phase B, then DIFFUSION_STEP_BATCHES phase-C steps of the main
    Adam, each optimizer step of the card's (and of a CPU copy whose inputs
    are nudged by 2^-24) from the CPU's params and that optimizer's state
    before it, on the CPU's batch, negatives and draws; the card on the
    CPU's phase-B picks and (MHRec) the CPU's item kNN picks, the CPU's
    segment sums in K4's summation order (``kernel_order_prefix``). Each
    gradient within the larger of the step bounds and SPREAD_FACTOR times
    its spread from the nudged copy and (MHRec) from the CPU's step with its
    prefixes summed in float64; the card's Adam step against float64
    Adam on its own gradient; params outside the step's optimizer unchanged
    on the card. Returns {loss, grad, adam (worst shares and where), steps
    (optimizer labels in order), flips (users or hyperedges whose card
    phase-B picks differ from the CPU's), k2 and k4 (the card's launches
    a phase-C step)}."""
    from chaorec_tpu_torch.data.sampling import make_epoch_batches
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.models.diffmm import DENOISERS, denoiser_names
    from chaorec_tpu_torch.models.mhrec import REBUILD_CHUNK
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum
    from chaorec_tpu_torch.params import clone_to
    from chaorec_tpu_torch.train.loop import ADAM_BETAS, ADAM_EPS, deterministic_mode, grads_into

    cpu_model, card_model = build_model(cfg, sds, "cpu"), build_model(cfg, sds, device)
    if name == "MHRec":  # the CPU's item kNN picks
        card_model.hyper_nodes_v = cpu_model.hyper_nodes_v.to(device)
        card_model.hyper_nodes_t = cpu_model.hyper_nodes_t.to(device)
    models = {"cpu": cpu_model, "card": card_model, "nudged": cpu_model}
    base = cpu_model.trainer_cls(cpu_model, sds, cfg)._base
    gen = base.generator
    p0 = base.init_params()
    params = {side: {k: v.detach().to(m.device, copy=True).requires_grad_()
                     for k, v in p0.items()} for side, m in models.items()}
    lr = float(cfg.learning_rate)
    nudge_gen = torch.Generator().manual_seed(66)
    # the sides' segment sums: the CPU's (and its nudged copy's) in K4's own
    # order; MHRec's prefixes also summed in float64 and rounded once, another
    # correct order, whose spread bounds a gradient too (as phase 46's)
    ctx = {"cpu": kernel_order_prefix, "card": contextlib.nullcontext,
           "nudged": kernel_order_prefix, "f64": lambda: plain_prefix_scan(float64=True)}
    if name == "MHRec":
        models["f64"] = cpu_model
        params["f64"] = {k: v.detach().clone().requires_grad_() for k, v in p0.items()}
    states = {}  # the CPU's Adam state of each optimizer, {name: (step, m, v)}
    out = dict(loss=0.0, grad=(0.0, ""), adam=(0.0, ""), steps=[], flips=0, k2=set(), k4=set())

    def step(label, names, loss_of):
        pre = {k: p.detach().cpu().clone() for k, p in params["cpu"].items()}
        st0 = states.get(label, {})
        rec = {}
        for side in models:
            on = models[side].device
            with torch.no_grad():
                for k, p in params[side].items():
                    x = pre[k]
                    if side == "nudged":
                        x = x * (1 + 2.0 ** -24 * torch.randn(x.shape, generator=nudge_gen))
                    p.copy_(x.to(on))
            opt = torch.optim.Adam([params[side][k] for k in names], lr=lr, betas=ADAM_BETAS,
                                   eps=ADAM_EPS)
            for k in names:
                if k in st0:
                    c, m0, v0 = st0[k]
                    set_adam_state(opt, params[side][k], c, m0.to(on), v0.to(on))
            reset_counts()
            with deterministic_mode(), ctx[side]():
                loss = loss_of(side, params[side])
                grads_into(loss, [params[side][k] for k in names])
                opt.step()
            if side == "card" and label == "main":
                out["k2"].add(lse_counts())
                out["k4"].add(prefix_cumsum.launches)
            rec[side] = dict(loss=loss.item(),
                             grads={k: params[side][k].grad.detach().cpu().clone() for k in names},
                             params={k: p.detach().cpu().clone() for k, p in params[side].items()},
                             state={k: adam_state(opt, params[side][k]) for k in names})
        c, g = rec["cpu"], rec["card"]
        out["steps"].append(label)
        out["loss"] = max(out["loss"], abs(g["loss"] - c["loss"]) / max(
            STEP_LOSS_RTOL * abs(c["loss"]), SPREAD_FACTOR * max(
                abs(o["loss"] - c["loss"]) for side, o in rec.items() if side not in ("cpu",
                                                                                    "card"))))
        scale = max(w.abs().max().item() for w in c["grads"].values())
        others = [rec[side] for side in models if side not in ("cpu", "card")]
        for k, want in c["grads"].items():
            base_tol = STEP_RTOL * want.abs().max().item() + STEP_ATOL * scale
            drift = max((o["grads"][k] - want).abs().max().item() for o in others)
            out["grad"] = max(out["grad"], ((g["grads"][k] - want).abs().max().item()
                                            / max(base_tol, SPREAD_FACTOR * drift),
                                            f"{k} of {label}"))
            count, m0, v0 = st0.get(k, (0, torch.zeros_like(want), torch.zeros_like(want)))
            p, m, v = adam_reference(pre[k], m0, v0, count, g["grads"][k], lr, ADAM_EPS)
            check(g["state"][k][0] == count + 1 == c["state"][k][0], f"{name} {label}: {k}'s count")
            for what, got, ref in (("", g["params"][k], p), (" first moment", g["state"][k][1], m),
                                   (" second moment", g["state"][k][2], v)):
                err = (got.double() - ref).abs().max().item()
                share = err / (ADAM_STEP_RTOL * ref.abs().max().item() + 1e-30)
                out["adam"] = max(out["adam"], (share, f"{k}{what} after {label}"))
        for k in set(pre) - set(names):
            check(torch.equal(g["params"][k], pre[k]), f"{name} {label} moved {k}")
        states[label] = c["state"]
        with torch.no_grad():  # every side goes on from the CPU's params
            for side in set(models) - {"cpu"}:
                for k, p in params[side].items():
                    p.copy_(c["params"][k].to(models[side].device))

    # phase A: each denoiser Adam over its batches
    bs = int(cfg.batch_size)
    groups = ((DENOISERS, cpu_model.num_user, None),) if name == "DiffMM" else (
        (("img_dn",), cpu_model.hyper_nodes_v.shape[0], cpu_model.hyper_nodes_v),
        (("txt_dn",), cpu_model.hyper_nodes_t.shape[0], cpu_model.hyper_nodes_t))
    for prefixes, n_rows, nodes in groups:
        names = denoiser_names(params["cpu"], prefixes)
        label = "+".join(prefixes)
        for batch in make_epoch_batches(gen, n_rows, bs)[:DIFFUSION_STEP_BATCHES]:
            draws = cpu_model.diffusion_draws(gen, batch.users.shape[0])

            def loss_of(side, p, batch=batch, draws=draws, nodes=nodes, prefix=prefixes[0]):
                m, on = models[side], models[side].device
                d = clone_to(draws, on)
                if name == "DiffMM":
                    return m.diffusion_loss_with_draws(p, batch.users.to(on), batch.weights.to(on), d)
                return m.hyper_diff_loss_with_draws(p, prefix, nodes[batch.users].to(on),
                                                    batch.weights.to(on), d)

            step(label, names, loss_of)
    # phase B on the CPU; the card's own picks counted against it
    with deterministic_mode(), torch.no_grad():
        card_p = {k: v.detach().to(device) for k, v in params["cpu"].items()}
        if name == "DiffMM":
            state = cpu_model.rebuild_graphs(params["cpu"], gen)
            for j, prefix in enumerate(DENOISERS):
                own = card_model.rebuild_topk(card_p, prefix).cpu()
                out["flips"] += int((own != state[j].topk).any(1).sum())
            states_on = {"cpu": state, "card": clone_to(state, device)}
        else:
            h = {}
            for prefix, nodes in (("img_dn", cpu_model.hyper_nodes_v),
                                  ("txt_dn", cpu_model.hyper_nodes_t)):
                noise = torch.randn((-(-nodes.shape[0] // REBUILD_CHUNK), REBUILD_CHUNK,
                                     cpu_model.num_nodes), generator=gen)
                h[prefix] = cpu_model.rebuild_incidence(params["cpu"], prefix, nodes, None, noise)
                own = card_model.rebuild_incidence(card_p, prefix, nodes.to(device), None,
                                                   noise.to(device)).cpu()
                out["flips"] += int((own != h[prefix]).any(1).sum())
            states_on = {side: models[side].with_incidence(
                models[side].init_state(), h["img_dn"].to(models[side].device),
                h["txt_dn"].to(models[side].device)) for side in ("cpu", "card")}
        states_on["nudged"] = states_on["f64"] = states_on["cpu"]
    # phase C: the main Adam over every param but the denoisers
    names = [k for k in params["cpu"] if k not in denoiser_names(params["cpu"], DENOISERS)]
    for batch in epoch_batches(base, cfg, DIFFUSION_STEP_BATCHES):
        draws = cpu_model.draws(gen, batch) if name == "MHRec" else None

        def loss_of(side, p, batch=batch, draws=draws):
            m, on = models[side], models[side].device
            if name == "DiffMM":
                return m.loss_bpr(p, states_on[side], batch_to(batch, on))
            return m.loss_stateful_with_draws(p, states_on[side], batch_to(batch, on),
                                              clone_to(draws, on))[0]

        step("main", names, loss_of)
    return out


def diffusion_phases(args, device, ds) -> tuple:
    """Phases 62-66: DiffMM's and MHRec's CLI runs on beauty through their
    trainers (62-63: each epoch split into its phases, K2's and K4's
    launches counted, the export skipped, a phase-A step and a phase-C step
    on the run's rebuilt graph profiled), K2 at their two contrast shapes (64), K4 at MHRec's shape
    with fp32 and bf16 input and ``seg_edge_weighted_sum`` against float64
    (65), and each optimizer step of both on the card against the CPU (66).
    Returns (their wall seconds, {model: (K2 fwd, dq, dk launches, K4
    launches, K4 calls by input dtype)} of the CLI runs, K2's results, K4's
    results)."""
    from chaorec_tpu_torch.data.sampling import make_epoch_batches
    from chaorec_tpu_torch.models.diffmm import DENOISERS, DiffusionFamilyTrainer
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum
    from chaorec_tpu_torch.train.loop import deterministic_mode

    t_start = time.perf_counter()
    groups = {"K2 (streaming logsumexp)": ("lse_",), "K4 (prefix scan)": ("lookback_scan",),
              "GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90"),
              "copies (dtype casts)": ("copy",),
              "sorts (top-k picks, the deterministic index sums)": ("sort", "radix", "bitonic"),
              "index kernels (gathers, their scatters, index_add_)": (
                  "index", "gather", "scatter"),
              "reductions (norms, sums, softmax)": ("reduce_kernel", "softmax"),
              "elementwise": ("elementwise",)}
    launches = {}
    # 62-63. diffmm, mhrec: cli.run through the family trainer -------------
    with tempfile.TemporaryDirectory() as tmp:
        for name in DIFFUSION_MODELS:
            phase = name.lower()
            cfg, _ = path_config(name, args)
            run_cfg = cfg.replace(num_epoch=DIFFUSION_EPOCHS, log_dir=args.out_dir,
                                  export_artifact=os.path.join(tmp, f"{name}.npz"))
            k4_steps = mhrec_k4_steps(cfg) if name == "MHRec" else 0
            trainers = []
            init = DiffusionFamilyTrainer.__init__
            DiffusionFamilyTrainer.__init__ = lambda self, *a: trainers.append(self) or init(
                self, *a)
            try:
                with BuildProbe() as built, PhaseTimer() as split, K4Dtypes() as k4d:
                    models, _ = linear_cli_run(phase, device, ds, name, run_cfg,
                                               first_combo(name)[1],
                                               lse_terms=DIFFUSION_TERMS[name], k4_steps=k4_steps)
            finally:
                DiffusionFamilyTrainer.__init__ = init
            launches[name] = (*lse_counts(), prefix_cumsum.launches, dict(k4d.counts))
            check_export_skipped(phase, name, run_cfg)
            model = models[0]
            check(model.device.type == device.type and type(model).__name__ == name,
                  f"{name} is not on the card")
            b = built.builds[0]
            sec = split.seconds
            shapes = (f"denoisers ({model.x.shape[1]} + 10 -> 1000 -> {model.x.shape[1]}) over "
                      f"{model.num_user} user rows, rebuild_k {model.rebuild_k}"
                      if name == "DiffMM" else
                      f"hyperedges {tuple(model.hyper_nodes_v.shape)} a modality, denoisers "
                      f"({model.num_nodes} + 10 -> 1000 -> {model.num_nodes}), "
                      f"{model.num_hypernodes} nodes a rebuilt hyperedge")
            say(phase, f"{name} build: {b['seconds']:.3f} s, peak device memory "
                f"{b['peak_gib']:.3f} GiB above what was allocated before it; {shapes}; epoch "
                f"split: phase A (denoisers, fresh Adams) {sec['A']:.3f} s, phase B (rebuild, no "
                f"gradient) {sec['B']:.3f} s, phase C (BPR steps) {sec['C']:.3f} s; the running "
                f"peak after each: " + ", ".join(f"{ph} {split.peak_gib[ph]:.2f} GiB"
                                                 for ph in sorted(split.peak_gib))
                + f"; K4 calls by input dtype {dict(k4d.counts)}")
            # one step of each phase under the profiler, on the graph the
            # run's epoch rebuilt (its picks set a phase-C step's sums)
            family = model.trainer_cls(model, ds, cfg)
            base = family._base
            params = base.init_params()
            main = base.make_optimizer(params)
            base.model_state = trainers[0]._base.model_state
            prefix, rows = ((DENOISERS, model.num_user) if name == "DiffMM"
                            else (("img_dn",), model.hyper_nodes_v.shape[0]))
            dn_opt = family.denoiser_adam(params, prefix)
            ub = make_epoch_batches(base.generator, rows, cfg.batch_size)[0]
            draws = model.diffusion_draws(base.generator, ub.users.shape[0])

            def phase_a_step():
                with deterministic_mode():
                    loss = (model.diffusion_loss_with_draws(params, ub.users, ub.weights, draws)
                            if name == "DiffMM" else model.hyper_diff_loss_with_draws(
                                params, "img_dn", model.hyper_nodes_v[ub.users], ub.weights,
                                draws))
                    return family.denoise_step(dn_opt, loss)

            batch = first_batch(base, cfg)
            for what, fn in (("phase A", phase_a_step),
                             ("phase C", lambda: base.train_step(params, main, batch))):
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                device_profile(phase, f"one {name} {what} step of {cfg.batch_size} "
                               f"{'rows' if what == 'phase A' else 'edges'} at {LINEAR_DATASET}",
                               fn, os.path.join(args.out_dir, f"chip_smoke_{phase}_"
                                                f"{what[-1].lower()}_step_profile.txt"),
                               groups=groups)
                k2, k4 = lse_counts(), prefix_cumsum.launches
                c_step = what == "phase C"  # device_profile steps three times
                expected = ((3 * DIFFUSION_TERMS[name] * c_step,) * 3, 3 * k4_steps * c_step)
                say(phase, f"{name} {what} step: peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K2 fwd/dq/dk "
                    f"launches {k2}, K4 {k4} (expected {expected[0]}, {expected[1]})")
                check((k2, k4) == expected and not any(other_counts(*kernel_wrappers()[3:7])),
                      f"{name} {what} step launched {k2}, {k4}")
            del models, model, family, base, params, main, dn_opt, trainers
            torch.cuda.empty_cache()

    # 64. k2diff: K2 at the two contrast shapes ----------------------------
    gen = torch.Generator(device=device).manual_seed(args.seed + 64)
    k2diff = diffusion_lse_phase(gen, device, ds, first_combo("DiffMM")[0]["ssl_temp"])
    check(first_combo("MHRec")[0]["ssl_temp"] == first_combo("DiffMM")[0]["ssl_temp"],
          "DiffMM and MHRec share one temperature here")

    # 65. k4mh: K4 at MHRec's shape, seg_edge_weighted_sum vs float64 ---------
    k4mh = mhrec_scan_phase(gen, device, path_config("MHRec", args)[0], ds)

    # 66. dfstep: each optimizer step on the card against the CPU -------------
    sds = synthetic_dataset(LINEAR_DATASET, args.seed + 1, shape=STEP_SHAPE, features=True)
    for name in DIFFUSION_MODELS:
        cfg, _ = path_config(name, args)
        cfg = cfg.replace(graph_compute_dtype="float32")
        t0 = time.perf_counter()
        r = diffusion_card_vs_cpu(name, cfg, sds, device)
        terms, k4_steps = DIFFUSION_TERMS[name], mhrec_k4_steps(cfg) if name == "MHRec" else 0
        say("dfstep", f"{name} at float32, {DIFFUSION_STEP_BATCHES} batches of each phase "
            f"({sds.num_user} x {sds.num_item}, dim {cfg.dim_E}, 4096- and 384-wide features), "
            f"optimizer steps {r['steps']}, each of the card's from the CPU's params and state, "
            f"the CPU's draws, phase-B picks (rows the card's own picks differ: {r['flips']}) "
            f"{'and item kNN ' if name == 'MHRec' else ''}: worst loss at {r['loss']:.3f} of "
            f"its bound, worst gradient {r['grad'][1]} at {r['grad'][0]:.3f} of its bound (the "
            f"larger of the step bounds and {SPREAD_FACTOR:g} x its spread from inputs nudged "
            f"by 2^-24); the card's Adam steps against float64 Adam on its own gradient: worst "
            f"{r['adam'][1]} at {r['adam'][0]:.3f} of {ADAM_STEP_RTOL:g} of the tensor's max; "
            f"launches a phase-C step: K2 {sorted(r['k2'])}, K4 {sorted(r['k4'])}; "
            f"{time.perf_counter() - t0:.1f} s")
        check(r["loss"] <= 1.0 and r["grad"][0] <= 1.0 and r["adam"][0] <= 1.0
              and r["k2"] == {(terms,) * 3} and r["k4"] == {k4_steps},
              f"{name} card steps disagree")
        torch.cuda.empty_cache()
    return time.perf_counter() - t_start, launches, k2diff, k4mh


# phases 67-69: a run resumed from its checkpoint against the uninterrupted
# run, through K1 (FREEDOM's tables, their moments and step count in the
# checkpoint), K3 (CF_Diff's Philox dropout seeds from the restored
# generator) and K4 (DGCF's routing scores restored); the supervisor's
# relaunch of a killed CLI child into its checkpoint; the profiler hook
RESUME_MODELS = ("FREEDOM", "CF_Diff", "DGCF")
RESUME_EPOCHS, RESUME_SPLIT = 3, 2  # 3 uninterrupted; 2, then resumed to 3
ELASTIC_TIMEOUT_S = 420


class CheckpointTimer:
    """While active, the seconds of each checkpoint save
    (``CheckpointManager.save``: the state to the host and the file) and
    each restore (``Trainer.restore``: the file onto the card and the
    copies into the live state), the device synchronized at both ends."""

    def __enter__(self):
        from chaorec_tpu_torch.train import checkpoint, loop

        self.save_s, self.restore_s = [], []
        self.patched = [(checkpoint.CheckpointManager, "save", self.save_s),
                        (loop.Trainer, "restore", self.restore_s)]
        self.orig = [getattr(cls, n) for cls, n, _ in self.patched]
        for (cls, n, out), fn in zip(self.patched, self.orig):
            setattr(cls, n, self._timed(fn, out))
        return self

    @staticmethod
    def _timed(fn, out):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
            return res
        return timed

    def __exit__(self, *exc):
        for (cls, n, _), fn in zip(self.patched, self.orig):
            setattr(cls, n, fn)


def tree_leaves(tree):
    """The leaves of nested dicts, tuples and lists, None included, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def same_bits(a, b) -> bool:
    """Equal structure, dtypes, shapes and bits (bf16 compared as int16)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x is None or y is None:
            if not (x is None and y is None):
                return False
        elif x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                *(t.view(torch.int16) if t.dtype == torch.bfloat16 else t for t in (x, y))):
            return False
    return True


def log_messages(path: str) -> list:
    """A CLI log file's messages, the date and level cut off."""
    with open(path) as fh:
        return [re.sub(r"^.*? (INFO|WARNING) ", "", line) for line in fh.read().splitlines()]


def epoch_lines(messages: list) -> dict:
    """{epoch: its lines from ``Epoch n, Loss`` through the metric tables}."""
    out, cur = {}, None
    for m in messages:
        if mt := re.match(r"Epoch (\d+), Loss: ", m):
            cur = out.setdefault(int(mt.group(1)), [])
        elif m.startswith("epoch_time_s"):
            cur = None
        if cur is not None:
            cur.append(m)
    return out


def resume_run(cfg, ds, device, ckpt: str, epochs: int, log_dir: str) -> dict:
    """``cfg``'s trainer run to ``epochs`` epochs with a checkpoint each
    epoch in ``ckpt`` (resumed from its newest step), logged into
    ``log_dir``: the epochs' losses, the best metrics, the launches by
    wrapper (counted from 0 just before ``run``), the seconds, the epochs'
    walls and peak, the log's messages and the final state on the host."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.params import clone_to
    from chaorec_tpu_torch.train import loop

    cfg = cfg.replace(num_epoch=epochs, checkpoint_dir=ckpt, checkpoint_every=1,
                      log_dir=log_dir)
    cli.setup_logging(cfg)
    model = build_model(cfg, ds, device)
    trainer = getattr(model, "trainer_cls", loop.Trainer)(model, ds, cfg)
    base = getattr(trainer, "_base", trainer)
    losses, opt = [], {}
    epoch_fn, make = base.train_epoch, base.make_optimizer

    def train_epoch(params, optimizer):
        losses.append(epoch_fn(params, optimizer))
        return losses[-1]

    def make_optimizer(params):
        opt["adam"] = make(params)
        return opt["adam"]

    base.train_epoch, base.make_optimizer = train_epoch, make_optimizer
    probe = EpochProbe()
    logging.getLogger().addFilter(probe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        best = trainer.run()
        torch.cuda.synchronize()
    finally:
        logging.getLogger().removeFilter(probe)
    out = dict(losses=losses, best=best, seconds=time.perf_counter() - t0, epochs=probe.epochs,
               launches={f.__name__: f.launches for f in kernel_wrappers()},
               messages=log_messages(os.path.join(log_dir, f"{cfg.Model}_{cfg.data_path}.log")),
               state=clone_to({"params": base.final_params,
                               "adam": loop.optimizer_tree(opt["adam"]),
                               "tables": base.table_state, "count": base.table_count,
                               "mstate": base.model_state,
                               "rng": base.generator.get_state()}, "cpu"),
               cam_layers=getattr(model, "cam_layers", 0))
    # the trainer and its wrapped methods hold each other: collect the cycle
    # before the next run measures its peak
    del trainer, base, model, opt, train_epoch, make_optimizer, epoch_fn, make
    gc.collect()
    torch.cuda.empty_cache()
    return out


def epoch_launches(cfg, ds, cam_layers: int) -> dict:
    """Each wrapper's launches in one epoch of ``cfg`` (training and its
    evaluation), read off the code as phases 7, 10 and 21 count them."""
    counts = {f.__name__: 0 for f in kernel_wrappers()}
    if cfg.Model == "CF_Diff":
        n_batches = math.ceil(ds.num_user / cfg.batch_size)
        evals = math.ceil(ds.num_user / cfg.eval_user_chunk) * cfg.steps * cam_layers
        counts["fused_mha"] = n_batches * cam_layers + evals
        counts["fused_mha_bwd"] = n_batches * cam_layers
    elif cfg.Model == "FREEDOM":
        counts["fused_row_adam"] = math.ceil(ds.num_edges / cfg.batch_size) * 2
    else:
        per_step, per_eval = scan_launches(cfg)
        counts["prefix_cumsum"] = math.ceil(ds.num_edges / cfg.batch_size) * per_step + per_eval
    return counts


def write_loader_files(ds, root: str) -> str:
    """``ds`` in the loader's format (``data/loading.py``) under
    ``root/<ds.name>``: train.npy with the items offset by the users, val
    and test rows [user, item...], both feature tables. Returns ``root``."""
    d = os.path.join(root, ds.name)
    os.makedirs(d)
    train = ds.train_edges.astype(np.int64)
    train[:, 1] += ds.num_user
    np.save(os.path.join(d, "train.npy"), train)
    for split in ("val", "test"):
        users, pos = getattr(ds, f"{split}_users"), getattr(ds, f"{split}_pos")
        rows = np.empty(len(users), dtype=object)
        for j, u in enumerate(users):
            rows[j] = [int(u)] + (pos.values[j, :pos.lengths[j]] + ds.num_user).tolist()
        np.save(os.path.join(d, f"{split}.npy"), rows, allow_pickle=True)
    np.save(os.path.join(d, "v_feat.npy"), ds.v_feat)
    np.save(os.path.join(d, "t_feat.npy"), ds.t_feat)
    return root


def child_pids(pid: int) -> list:
    """The processes whose parent is ``pid`` (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as fh:
                    stat = fh.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(d))
    return out


def kill_tree(pid: int) -> None:
    """SIGKILL ``pid``'s descendants, then ``pid``."""
    for kid in child_pids(pid):
        kill_tree(kid)
    with contextlib.suppress(ProcessLookupError):
        os.kill(pid, signal.SIGKILL)


def resume_phase(args, device, datasets) -> dict:
    """Phase 67: FREEDOM (K1), CF_Diff (K3) and DGCF (K4), each at its
    first combo through its trainer: RESUME_EPOCHS epochs uninterrupted,
    and RESUME_SPLIT epochs then a resume to RESUME_EPOCHS from the same
    directory, a checkpoint each epoch. Equal loss bits, best metrics,
    params, Adam state, tables (moments and count), model state and
    generator state; the resumed run's launches exactly one epoch's.
    Returns {model: the resumed run's launches, and the uninterrupted run}."""
    from chaorec_tpu_torch.train.checkpoint import CheckpointManager

    out = {}
    for name in RESUME_MODELS:
        cfg, ds_name = path_config(name, args)
        ds = datasets[ds_name]
        logs = os.path.join(args.out_dir, "resume", name)
        with tempfile.TemporaryDirectory() as tmp, CheckpointTimer() as timer:
            full = resume_run(cfg, ds, device, os.path.join(tmp, "full"), RESUME_EPOCHS,
                              os.path.join(logs, "full"))
            first = resume_run(cfg, ds, device, os.path.join(tmp, "split"), RESUME_SPLIT,
                               os.path.join(logs, "first"))
            restore_mark = len(timer.restore_s)
            rest = resume_run(cfg, ds, device, os.path.join(tmp, "split"), RESUME_EPOCHS,
                              os.path.join(logs, "rest"))
            step_dir = CheckpointManager(os.path.join(tmp, "split")).step_dir(RESUME_EPOCHS)
            ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                             for f in os.listdir(step_dir))
        one = epoch_launches(cfg, ds, full["cam_layers"])
        state = {k: same_bits(full["state"][k], rest["state"][k]) for k in full["state"]}
        say("resume", f"{name} ({ds_name}, {cfg.batch_size} a batch): {RESUME_EPOCHS} epochs "
            f"uninterrupted {full['seconds']:.3f} s; {RESUME_SPLIT} epochs {first['seconds']:.3f} s, "
            f"then resumed to {RESUME_EPOCHS} {rest['seconds']:.3f} s; losses "
            f"{full['losses']} vs {first['losses'] + rest['losses']}")
        say("resume", f"{name}: bit-equal after the resume: "
            + ", ".join(f"{k} {v}" for k, v in state.items())
            + f"; best metrics equal {rest['best'] == full['best']}")
        say("resume", f"{name}: resumed run's launches "
            f"{ {k: v for k, v in rest['launches'].items() if v} } (one epoch: "
            f"{ {k: v for k, v in one.items() if v} }); uninterrupted "
            f"{ {k: v for k, v in full['launches'].items() if v} }")
        say("resume", f"{name}: save {np.mean(timer.save_s):.3f} s a checkpoint (min "
            f"{min(timer.save_s):.3f}, max {max(timer.save_s):.3f}, {len(timer.save_s)} saves), "
            f"restore {timer.restore_s[restore_mark]:.3f} s, checkpoint {ckpt_bytes} bytes "
            f"({ckpt_bytes / 2 ** 20:.1f} MiB); resumed run's peak device memory "
            f"{max(ep['peak_gib'] for ep in rest['epochs']):.2f} GiB (uninterrupted "
            f"{max(ep['peak_gib'] for ep in full['epochs']):.2f})")
        check(f"resumed from checkpoint at epoch {RESUME_SPLIT}" in rest["messages"],
              f"{name}: the resumed run did not log its resume")
        check(len(full["losses"]) == RESUME_EPOCHS and all(map(math.isfinite, full["losses"])),
              f"{name}: losses {full['losses']}")
        check(first["losses"] + rest["losses"] == full["losses"],
              f"{name}: the resumed run's losses differ from the uninterrupted run's")
        check(rest["best"] == full["best"], f"{name}: best metrics differ")
        check(all(state.values()), f"{name}: state after the resume differs: {state}")
        check(rest["launches"] == one and full["launches"] == {
            k: RESUME_EPOCHS * v for k, v in one.items()} and first["launches"] == {
            k: RESUME_SPLIT * v for k, v in one.items()},
            f"{name}: launches {rest['launches']}, expected {one} an epoch")
        check(len(timer.restore_s) == restore_mark + 1, f"{name}: restores {timer.restore_s}")
        out[name] = dict(launches=rest["launches"], full=full)
    return out


class ElasticRun:
    """Phase 68: the supervisor relaunches a SIGKILLed CLI child, which
    resumes from its checkpoint. The supervisor starts here, with
    FREEDOM's set written in the loader's format, and runs beside the
    script's later phases (48-67); a thread SIGKILLs its CLI child as soon
    as the child's first checkpoint exists. ``collect`` waits for it and
    holds the relaunched run to phase 67's uninterrupted FREEDOM run. An
    exit of this interpreter ends the supervisor still running; ``stop``
    removes its directory."""

    def __init__(self, args, fds):
        from chaorec_tpu_torch.data.loading import data_load

        t_start = time.perf_counter()
        self.sup = None
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
        atexit.register(self.stop)
        # absolute: the child runs from the checkout's root, the script from anywhere
        self.log_dir = os.path.abspath(os.path.join(args.out_dir, "elastic"))
        os.makedirs(self.log_dir, exist_ok=True)
        root = write_loader_files(fds, os.path.join(self.tmp, "data"))
        back = data_load(fds.name, root, has_v=True, has_t=True)
        check(all(np.array_equal(getattr(back, k), getattr(fds, k)) for k in (
            "train_edges", "val_users", "test_users", "v_feat", "t_feat")) and all(
            np.array_equal(getattr(back, k).values, getattr(fds, k).values)
            for k in ("history", "val_pos", "test_pos")),
            "the written set does not load back as the phase's set")
        del back
        self.name = fds.name
        self.write_s = time.perf_counter() - t_start
        self.ckpt = os.path.join(self.tmp, "ckpt")
        cmd = [sys.executable, "-m", "chaorec_tpu_torch.elastic", "--retries", "2", "--",
               sys.executable, "-m", "chaorec_tpu_torch.cli", "--Model", "FREEDOM",
               "--data_path", fds.name, "--data_root", root, "--num_epoch", str(RESUME_EPOCHS),
               "--checkpoint_dir", self.ckpt, "--checkpoint_every", "1", "--seed",
               str(args.seed), "--log_dir", self.log_dir]
        self.out_path = os.path.join(self.log_dir, "supervisor.txt")
        self.killed = self.kids = self.run_s = None
        self.t0 = time.perf_counter()
        with open(self.out_path, "w") as out:
            self.sup = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                        cwd=os.path.dirname(os.path.abspath(__file__)))
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def _watch(self) -> None:
        """Kills the CLI child once combo_0/step_1 exists; ends the
        supervisor past ELASTIC_TIMEOUT_S."""
        step1 = os.path.join(self.ckpt, "combo_0", "step_1")
        sup = self.sup
        try:
            while sup.poll() is None and time.perf_counter() - self.t0 < ELASTIC_TIMEOUT_S:
                if self.killed is None and os.path.isdir(step1):
                    self.kids = child_pids(sup.pid)
                    if len(self.kids) != 1:
                        break
                    os.kill(self.kids[0], signal.SIGKILL)
                    self.killed = time.perf_counter() - self.t0
                time.sleep(0.02)
        finally:
            if sup.poll() is None:
                kill_tree(sup.pid)
                sup.wait()
            self.run_s = time.perf_counter() - self.t0

    def collect(self, full) -> float:
        """Waits for the supervisor and checks its run; ``full`` is phase
        67's uninterrupted FREEDOM run, whose epoch lines the relaunch must
        repeat. Returns the seconds this call waited."""
        t_start = time.perf_counter()
        self.watcher.join()
        with open(self.out_path) as fh:
            sup_out = fh.read()
        cursor_path = os.path.join(self.ckpt, "grid_cursor.json")
        cursor = {}
        if os.path.exists(cursor_path):
            with open(cursor_path) as fh:
                cursor = json.load(fh)
        self.stop()
        check(self.kids is None or len(self.kids) == 1,
              f"the supervisor has children {self.kids}, expected one")
        check(self.killed is not None, "combo_0/step_1 never appeared: no child was killed")
        check(self.run_s < ELASTIC_TIMEOUT_S and self.sup.returncode == 0,
              f"the supervisor exited {self.sup.returncode} after {self.run_s:.1f} s (see "
              f"{self.out_path})")
        check("# elastic: attempt 1 exited rc=-9" in sup_out and "launch attempt 2" in sup_out,
              "the supervisor did not relaunch the killed child")
        messages = log_messages(os.path.join(self.log_dir, f"FREEDOM_{self.name}.log"))
        start = next(i for i, m in enumerate(messages) if m.startswith("=========1/1"))
        first = next(m for m in messages[start:] if m.startswith(("resumed from", "Epoch ")))
        mt = re.match(r"resumed from checkpoint at epoch (\d+)$", first)
        check(mt is not None, f"the relaunched run starts with {first!r}, not its resume")
        n = int(mt.group(1))
        got, want = epoch_lines(messages), epoch_lines(full["messages"])
        check(1 <= n < RESUME_EPOCHS and sorted(got) == list(range(n + 1, RESUME_EPOCHS + 1)),
              f"resumed at {n}, epochs logged {sorted(got)}")
        check(all(got[e] == want[e] for e in got),
              "the relaunched run's epoch lines differ from phase 67's uninterrupted run's")
        check({int(k): v for k, v in cursor.get("0", {}).items()} == full["best"],
              f"the grid cursor holds {cursor}, not combo 0's best metrics")
        say("elastic", f"FREEDOM's set written in the loader's format and loaded back equal "
            f"({self.write_s:.2f} s); supervisor + CLI child, --num_epoch {RESUME_EPOCHS}, a "
            f"checkpoint each epoch, beside phases 48-67: child SIGKILLed {self.killed:.2f} s in "
            f"(combo_0/step_1 written), relaunched (rc -9 seen, the card probed), resumed at "
            f"epoch {n}, epochs {n + 1}-{RESUME_EPOCHS} equal to phase 67's lines, cursor "
            f"records combo 0 with the uninterrupted run's best metrics; supervisor exit 0 "
            f"after {self.run_s:.2f} s")
        return time.perf_counter() - t_start

    def stop(self) -> None:
        if self.sup is not None and self.sup.poll() is None:
            kill_tree(self.sup.pid)
            self.sup.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def trace_phase(args, device, fds, full) -> dict:
    """Phase 69: FREEDOM 2 epochs with ``profile_dir``: the trace of epoch
    2 holds K1's kernel once a launch of that epoch. ``full`` is phase
    67's uninterrupted FREEDOM run (its epoch 2 unprofiled). Returns the
    trace's numbers."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.ops.row_adam import fused_row_adam
    from chaorec_tpu_torch.train.loop import Trainer

    cfg, _ = path_config("FREEDOM", args)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cfg.replace(num_epoch=2, profile_dir=os.path.join(tmp, "prof"),
                          log_dir=os.path.join(args.out_dir, "trace"))
        cli.setup_logging(cfg)
        trainer = Trainer(build_model(cfg, fds, device), fds, cfg)
        per_epoch = []
        epoch_fn = trainer.train_epoch

        def train_epoch(params, optimizer):
            before = fused_row_adam.launches
            loss = epoch_fn(params, optimizer)
            per_epoch.append(fused_row_adam.launches - before)
            return loss

        trainer.train_epoch = train_epoch
        probe = EpochProbe()
        logging.getLogger().addFilter(probe)
        reset_counts()
        t0 = time.perf_counter()
        try:
            trainer.run()
            torch.cuda.synchronize()
        finally:
            logging.getLogger().removeFilter(probe)
        run_s = time.perf_counter() - t0
        path = os.path.join(cfg.profile_dir, "epoch_2.trace.json")
        files = os.listdir(cfg.profile_dir)
        nbytes = os.path.getsize(path)
        t1 = time.perf_counter()
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        parse_s = time.perf_counter() - t1
        del trainer, train_epoch, epoch_fn
    gc.collect()
    torch.cuda.empty_cache()
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = sum("row_adam_kernel" in e.get("name", "") for e in kernels)
    n_batches = math.ceil(fds.num_edges / cfg.batch_size)
    with_s, without_s = probe.epochs[1]["wall_s"], full["epochs"][1]["wall_s"]
    say("trace", f"FREEDOM 2 epochs with --profile_dir: {files} ({nbytes} bytes, "
        f"{nbytes / 2 ** 20:.1f} MiB; {len(events)} events, {len(kernels)} device kernels; "
        f"parsed in {parse_s:.2f} s); row_adam_kernel events {k1}, epoch 2's fused_row_adam "
        f"launches {per_epoch[1]} (expected {n_batches} x 2 tables); epoch 2 wall "
        f"{with_s:.3f} s profiled, {without_s:.3f} s unprofiled (phase 67), overhead "
        f"{100 * (with_s / without_s - 1):.1f}%; run {run_s:.2f} s (trace export included)")
    check(files == ["epoch_2.trace.json"], f"profile_dir holds {files}")
    check(per_epoch == [n_batches * 2] * 2 and k1 == per_epoch[1],
          f"the trace holds {k1} row_adam_kernel events, epoch 2 launched {per_epoch}")
    return dict(bytes=nbytes, events=len(events), kernels=len(kernels), row_adam=k1,
                with_s=with_s, without_s=without_s)


def resume_phases(args, device, datasets, elastic: ElasticRun) -> tuple:
    """Phases 67-69 (68's supervisor, ``elastic``, started before phase
    48). Returns (their seconds, phase 67's resumed runs' launches by
    model, phase 69's trace numbers)."""
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    resumed = resume_phase(args, device, datasets)
    say("resume", f"phase 67: {time.perf_counter() - t0:.1f} s")
    full = resumed["FREEDOM"]["full"]
    waited = elastic.collect(full)
    say("elastic", f"phase 68: {elastic.run_s:.1f} s beside phases 48-67, {waited:.1f} s "
        f"waited for here")
    t0 = time.perf_counter()
    trace = trace_phase(args, device, datasets[FREEDOM_DATASET], full)
    say("trace", f"phase 69: {time.perf_counter() - t0:.1f} s")
    return (time.perf_counter() - t_start,
            {name: r["launches"] for name, r in resumed.items()}, trace)


# Phases 70-72: the mesh through the CLI's own spawn, ranks on the one card
MESH_RUNS = (("FREEDOM", "dp=1,mp=1"), ("FREEDOM", "dp=1,mp=3"), ("SGL", "dp=2"))
MESH_TIMEOUT_S = 300  # one CLI child: its ranks' start, the set's load, the build, an epoch
# K1 at a rank's shard of FREEDOM's tables under mp=3, K2 at SGL's half batch under dp=2
MESH_ROW_ADAM = tuple((name, (n // 3, d)) for name, (n, d) in ROW_ADAM_SHAPES)
MESH_LSE = {side: (shape[0] // 2,) + shape[1:] for side, shape in LSE_MAIN.items()}
# a dp split sums each gradient in another order: tests/test_parallel.py's loss tolerance
MESH_LOSS_RTOL = 1e-4
# ... and so may move a param as far as that reordering moves it on one device
# (an epoch with each batch's rows permuted), times this; a planted fault moves
# SGL's params 43-208x that far (scripts/probe_dp_split_drift.py, PERF.md)
MESH_DRIFT_FACTOR = 4.0


def lse_hold(gen, device, shape, errs: dict, phase: str = "kernel") -> None:
    """K2's forward, dq and (k with a gradient) dk at ``shape`` against
    the plain version and its autograd; ``errs`` keeps each kernel's
    largest abs error; the line printed under ``phase``."""
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_logsumexp,
                                                     streaming_logsumexp_reference)

    b, n, e, temp, k_grad = shape
    q, k, g = lse_inputs(gen, shape, device)
    inputs = (q, k) if k_grad else (q,)
    before = lse_counts()
    got = streaming_logsumexp(q, k)
    grads = torch.autograd.grad(got, inputs, g)
    torch.cuda.synchronize()
    launched = tuple(a - c for a, c in zip(lse_counts(), before))
    check(launched == (1, 1, int(k_grad)), f"lse {shape} launched {launched}")
    want = streaming_logsumexp_reference(q, k)
    wgrads = torch.autograd.grad(want, inputs, g)
    fwd_share = tol_share(got, want, **LSE_TOL)
    errs["fwd"] = max(errs["fwd"], (got - want).abs().max().item())
    rel_tol = LSE_BWD_REL_TOL * max(1.0, 0.1 / temp)
    rels = []
    for name, a, w in zip(("dq", "dk"), grads, wgrads):
        err = (a - w).abs().max().item()
        errs[name] = max(errs[name], err)
        rels.append(err / w.abs().max().item())
    say(phase, f"streaming_logsumexp ({b}, {n}, {e}) at temperature {temp}, k "
        f"{'with' if k_grad else 'without'} gradient: launches fwd/dq/dk {launched}; "
        f"fwd max abs err {(got - want).abs().max().item():.3e} ({fwd_share:.3f} of rtol/atol "
        f"1e-5); dq{', dk' if k_grad else ''} max abs err / max |plain| "
        + ", ".join(f"{r:.2e}" for r in rels) + f" (bound {rel_tol:g})")
    check(fwd_share <= 1.0 and max(rels) <= rel_tol, f"streaming_logsumexp {shape} disagrees")


def k1_shard_phase(gen, device, full_rows: int) -> dict:
    """K1 (through table_adam_update, as a mesh rank calls it) at each mp=3
    shard of FREEDOM's tables: one step of a batch's 2048 rows of the whole
    table, the rows rank 0 does not own mapped to the shard's padding id,
    against row_adam_update on the rows it owns; then its times beside the
    plain version, the library's step and the bound. Returns per table
    {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}."""
    from chaorec_tpu_torch.ops.indexed_adam import (init_table_state, row_adam_update,
                                                    table_adam_update)
    from chaorec_tpu_torch.ops.row_adam import (fused_row_adam, prepare_sorted_rows,
                                                row_adam_reference)

    out = {}
    for name, (n, d) in MESH_ROW_ADAM:
        p0 = torch.randn((n, d), generator=gen, device=device)
        rows = row_adam_rows(gen, full_rows, 2048, device)
        local = torch.where(rows < n, rows, torch.full_like(rows, n))  # rank 0 owns [0, n)
        g = torch.randn((2048, d), generator=gen, device=device)
        count = torch.tensor(1, dtype=torch.int32, device=device)
        before = fused_row_adam.launches
        kp, ks = table_adam_update(p0.clone(), init_table_state(p0), local, g, count,
                                   ROW_ADAM_LR)
        torch.cuda.synchronize()
        check(fused_row_adam.launches == before + 1, "table_adam_update did not launch")
        own = rows < n
        pp, ps = row_adam_update(p0.clone(), init_table_state(p0), rows[own], g[own], count,
                                 ROW_ADAM_LR)
        worst, err = 0.0, 0.0
        for got, want, tol in ((kp, pp, ROW_P_TOL), (ks.m, ps.m, ROW_P_TOL),
                               (ks.v, ps.v, ROW_V_TOL)):
            worst = max(worst, tol_share(got, want, **tol))
            err = max(err, (got - want).abs().max().item())
        check(worst <= 1.0, f"fused_row_adam at the shard {name} ({n}, {d}) disagrees")
        r_s, g_s = prepare_sorted_rows(local, g, n)
        distinct = int((r_s < n).sum())
        m = torch.rand((n, d), generator=gen, device=device) * 1e-3
        v = torch.rand((n, d), generator=gen, device=device) * 1e-6
        ms = cuda_ms(lambda: fused_row_adam(kp, m, v, r_s, g_s, count, ROW_ADAM_LR), 20)
        plain_ms = cuda_ms(lambda: row_adam_reference(kp, m, v, r_s, g_s, count, ROW_ADAM_LR), 5)
        bms, by = bound_ms(10 * n * d, 6 * n * d * 4 + distinct * d * 4 + 2048 * 4 + 4)
        lib_p = torch.nn.Parameter(kp.clone())
        opt = torch.optim.Adam([lib_p], lr=ROW_ADAM_LR, fused=True)
        idx, g_own = local[own], g[own]

        def library():
            lib_p.grad = torch.zeros_like(lib_p).index_add_(0, idx, g_own)
            opt.step()

        library_ms = cuda_ms(library, 10)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bms, bound_by=by)
        say("mesh", f"fused_row_adam at rank 0's mp=3 shard of {name} ({n}, {d}) fp32, 2048 "
            f"rows of the batch ({distinct} its own, the rest the padding id): vs row_adam_update "
            f"max abs err {err:.3e} ({worst:.3f} of its tolerance); kernel {ms:.4f} ms "
            f"({100 * bms / ms:.1f}% of its bound), plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), library (zeros + index_add_ + Adam(fused=True).step) {library_ms:.4f} ms")
        del p0, kp, ks, pp, ps, m, v, lib_p, opt
        torch.cuda.empty_cache()
    return out


def k2_half_phase(gen, device) -> dict:
    """K2 at SGL's dp=2 half batch (512 rows of q against the whole user
    and item tables): held to the plain version, then timed. Returns
    {"max_abs_err": {kernel: err}, side: {kernel: timings}}."""
    errs = {"fwd": 0.0, "dq": 0.0, "dk": 0.0}
    for shape in MESH_LSE.values():
        lse_hold(gen, device, shape, errs)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {"max_abs_err": errs}
    for side, shape in MESH_LSE.items():
        q, k, g = lse_inputs(gen, shape, device)
        out[side] = lse_timings("mesh", f"SGL dp=2 {side}", q.detach(), k.detach(), g, True,
                                sms)
        del q, k, g
    torch.cuda.empty_cache()
    return out


def single_run(cfg, ds, device, ckpt: str, log_dir: str) -> dict:
    """``cfg``'s trainer on one device, one epoch, a checkpoint in
    ``ckpt``: its loss, the sha256 of its rank lists, its launches (counted
    from 0 just before), seconds and peak device memory."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.train import loop

    cfg = cfg.replace(num_epoch=1, checkpoint_dir=ckpt, checkpoint_every=1, log_dir=log_dir)
    cli.setup_logging(cfg)
    trainer = loop.Trainer(build_model(cfg, ds, device), ds, cfg)
    seen = {}
    epoch_fn, evaluate = trainer.train_epoch, trainer.evaluate

    def train_epoch(params, optimizer):
        seen["loss"] = epoch_fn(params, optimizer)
        return seen["loss"]

    def evaluate_and_keep(params):
        out = evaluate(params)
        seen["rank_list"] = out[2].cpu()
        seen["lists"] = hashlib.sha256(seen["rank_list"].numpy().tobytes()).hexdigest()
        return out

    trainer.train_epoch, trainer.evaluate = train_epoch, evaluate_and_keep
    cuda = torch.device(device).type == "cuda"  # scripts/probe_dp_split_drift.py runs it on the CPU
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer.run()
    if cuda:
        torch.cuda.synchronize()
    out = dict(seen, seconds=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else math.nan,
               launches={f.__name__: f.launches for f in kernel_wrappers()})
    del trainer, train_epoch, evaluate_and_keep, epoch_fn, evaluate
    gc.collect()
    torch.cuda.empty_cache()
    return out


class MeshRuns:
    """Phases 70-72's CLI children (MESH_RUNS), started together, with
    the sports-sized set written in the loader's format, while the script
    goes on with its earlier phases (the children spawn their ranks on this
    card; phase 70 collects them). Each child is ``python -m
    chaorec_tpu_torch.cli`` of its model's first combo with ``--mesh_shape``,
    one epoch and a checkpoint. An exit of this interpreter ends any child
    still running; ``stop`` removes their directory."""

    def __init__(self, args, fds):
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        atexit.register(self.stop)
        self.root = write_loader_files(fds, os.path.join(self.tmp, "data"))
        here = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
        self.runs = []
        for model, spec in MESH_RUNS:
            run_dir = os.path.join(self.tmp, f"{model}-{spec}")
            os.makedirs(os.path.join(run_dir, "Model_YAML"))
            with open(os.path.join(run_dir, "Model_YAML", f"{model}.yaml"), "w") as fh:
                json.dump(first_combo(model)[1], fh)  # JSON is YAML
            log_dir = os.path.abspath(os.path.join(args.out_dir, "mesh", f"{model}-{spec}"))
            os.makedirs(log_dir, exist_ok=True)
            run = dict(model=model, spec=spec, log_dir=log_dir,
                       state=os.path.join(run_dir, "ckpt", "combo_0", "step_1", "state.pt"))
            cmd = [sys.executable, "-m", "chaorec_tpu_torch.cli", "--Model", model,
                   "--data_path", FREEDOM_DATASET, "--data_root", self.root, "--num_epoch", "1",
                   "--seed", str(args.seed), "--checkpoint_dir", os.path.join(run_dir, "ckpt"),
                   "--checkpoint_every", "1", "--log_dir", log_dir, "--mesh_shape", spec]
            with open(os.path.join(log_dir, "child.txt"), "w") as out:
                run["t0"] = time.perf_counter()
                run["proc"] = subprocess.Popen(cmd, cwd=run_dir, env=env, stdout=out,
                                               stderr=subprocess.STDOUT)
            # the child's end, read off the clock as it exits
            run["waiter"] = ThreadPoolExecutor(1)
            run["end"] = run["waiter"].submit(lambda p=run["proc"]: (p.wait(),
                                                                     time.perf_counter()))
            self.runs.append(run)

    def collect(self) -> list:
        """Each child's run once it has ended: its seconds, its log's
        messages, each rank's peak memory (GiB) and launches, and its
        checkpoint's file."""
        out = []
        for run in self.runs:
            rc, end = run["end"].result(timeout=MESH_TIMEOUT_S)
            run["waiter"].shutdown()
            with open(os.path.join(run["log_dir"], "child.txt")) as fh:
                tail = fh.read()[-3000:]
            check(rc == 0, f"{run['model']} --mesh_shape {run['spec']} exited {rc}: {tail}")
            messages = log_messages(os.path.join(run["log_dir"],
                                                 f"{run['model']}_{FREEDOM_DATASET}.log"))
            ranks = {}
            for m in messages:
                if mt := re.match(rf"mesh {re.escape(spec_of(run['spec']))} rank (\d+) \(dp \d+, "
                                  r"mp \d+\): peak device memory (.+?); kernel launches (.*)$", m):
                    peak = mt.group(2)
                    ranks[int(mt.group(1))] = dict(
                        peak_gib=float(peak[:-4]) if peak.endswith(" GiB") else math.nan,
                        launches={k: int(v) for k, v in
                                  (x.split() for x in mt.group(3).split(", "))})
            out.append(dict(model=run["model"], spec=run["spec"], seconds=end - run["t0"],
                            messages=messages, ranks=ranks, state=run["state"]))
        return out

    def stop(self) -> None:
        for run in self.runs:
            if run["proc"].poll() is None:
                kill_tree(run["proc"].pid)
                run["proc"].wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def spec_of(spec: str) -> str:
    """``--mesh_shape``'s spelling as the port logs it ("dp=2" is "dp=2,mp=1")."""
    from chaorec_tpu_torch.parallel.mesh import parse_mesh_spec

    dp, mp = parse_mesh_spec(spec)
    return f"dp={dp},mp={mp}"


def mesh_epoch_line(messages: list, spec: str) -> tuple:
    """(loss, rank lists sha256, replicated params sha256, ranks) of the
    mesh's epoch-1 line."""
    for m in messages:
        if mt := re.match(rf"mesh {re.escape(spec_of(spec))} epoch 1: loss (\S+), rank lists "
                          r"sha256 (\w+), replicated params sha256 (\w+), the same on all "
                          r"(\d+) ranks$", m):
            return float.fromhex(mt.group(1)), mt.group(2), mt.group(3), int(mt.group(4))
    raise AssertionError(f"no epoch line of mesh {spec}")


def top_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """The mean share of a user's list in ``a`` that is in its list in ``b``."""
    return float(np.mean([len(set(x) & set(y)) / len(x)
                          for x, y in zip(a.tolist(), b.tolist())]))


def row_permuted(loss_fn, seed: int = 1):
    """``loss_fn`` on each batch's rows permuted (the same loss, its sums
    taken in another order)."""
    perm_gen = torch.Generator().manual_seed(seed)

    def loss(p, b, g):
        perm = torch.randperm(b.users.shape[0], generator=perm_gen).to(b.users.device)
        return loss_fn(p, dataclasses.replace(
            b, users=b.users[perm], weights=b.weights[perm], pos_items=b.pos_items[perm],
            neg_items=b.neg_items[perm]), g)

    return loss


def permuted_epoch(cfg, ds, device) -> dict:
    """One epoch of ``cfg``'s trainer on one device with each batch's rows
    permuted, then an evaluation: its loss, params and rank lists."""
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.train import loop

    trainer = loop.Trainer(build_model(cfg, ds, device), ds, cfg)
    params = trainer.init_params()
    optimizer = trainer.make_optimizer(params)
    trainer.model.loss = row_permuted(trainer.model.loss)
    trainer.model.pre_epoch(params, 0)
    loss = trainer.train_epoch(params, optimizer)
    rank_list = trainer.evaluate(params)[2].cpu()
    out = dict(loss=loss, params={k: v.detach().cpu() for k, v in params.items()},
               rank_list=rank_list)
    del trainer, params, optimizer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def param_drift(params: dict, want: dict) -> dict:
    """Each param's largest abs difference from ``want``'s."""
    return {k: (params[k].float().cpu() - want[k].float().cpu()).abs().max().item()
            for k in want}


def split_lists(args, model: str, ds, device, state: str, ref_state: str) -> dict:
    """The rank lists one device's trainer gives at the params of the
    checkpoint ``state`` (with their sha256), and each param's largest
    abs difference from ``ref_state``'s (``drift``)."""
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.train import loop

    cfg, _ = path_config(model, args)
    params = torch.load(state, map_location=device, weights_only=True)["params"]
    want = torch.load(ref_state, map_location=device, weights_only=True)["params"]
    trainer = loop.Trainer(build_model(cfg, ds, device), ds, cfg)
    rank_list = trainer.evaluate(params)[2].cpu()
    drift = param_drift(params, want)
    del trainer, params, want
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rank_list=rank_list, drift=drift,
                sha=hashlib.sha256(rank_list.numpy().tobytes()).hexdigest())


def mesh_phases(args, device, fds, children: MeshRuns) -> tuple:
    """Phases 70-72: the CLI's self-spawned mesh on this card. (70) FREEDOM
    under dp=1,mp=1, a world of one over NCCL, and (71) under dp=1,mp=3,
    three gloo ranks sharing the card (the 15207-row tables shard at mp=3
    only; the 28940-row user table stays whole), each bit-equal to the
    single-device trainer (loss, rank lists, checkpoint: params, Adam,
    tables' moments, generator), K1 launched on every rank and held at the
    shards' shape; (72) SGL under dp=2, two gloo ranks each stepping half
    of every batch through K2 (held and timed at that shape), its loss
    within MESH_LOSS_RTOL of the single-device run's, its replicated
    params bit-equal on both ranks, its rank lists (which rank 0's
    checkpointed params give here too) within TOPK_AGREE_MIN of one
    device's and each param within MESH_DRIFT_FACTOR times the drift an
    epoch with each batch's rows permuted shows on one device: the split
    sums each gradient in another order (and rounds each slice's
    propagated gradient to bf16), Adam turns the sign of some near-zero
    sums, and the bf16 scores of a random-weight set hold near ties.
    Returns (seconds, K1 at the shards, K2
    at the half batch, each run's ranks' launches by spec). The three CLI
    children (``children``) ran together beside the earlier phases; the
    references, the holds and the checks run here."""
    t_start = time.perf_counter()
    k1 = k1_shard_phase(torch.Generator(device=device).manual_seed(args.seed + 70), device,
                        fds.num_item)
    k2 = k2_half_phase(torch.Generator(device=device).manual_seed(args.seed + 72), device)
    launches = {}
    refs = {}
    for model in ("FREEDOM", "SGL"):
        cfg, _ = path_config(model, args)
        ckpt = os.path.join(children.tmp, f"{model}-single")
        refs[model] = single_run(cfg, fds, device, ckpt,
                                 os.path.join(args.out_dir, "mesh", f"{model}-single"))
        refs[model]["state"] = os.path.join(ckpt, "step_1", "state.pt")
        say("mesh", f"{model} on one device, 1 epoch: loss {refs[model]['loss']!r}, "
            f"{refs[model]['seconds']:.2f} s, peak {refs[model]['peak_gib']:.2f} GiB, "
            f"launches { {k: v for k, v in refs[model]['launches'].items() if v} }")
    for phase, run in zip((70, 71, 72), children.collect()):
        model, spec = run["model"], run["spec"]
        ref = refs[model]
        loss, lists, replicated, n_ranks = mesh_epoch_line(run["messages"], spec)
        world = math.prod(int(x.split("=")[1]) for x in spec_of(spec).split(","))
        backend = next(m for m in run["messages"] if m.startswith(f"mesh {spec_of(spec)}: "))
        check(n_ranks == world and sorted(run["ranks"]) == list(range(world)),
              f"{spec}: {n_ranks} ranks agree, {sorted(run['ranks'])} reported")
        check(("NCCL" in backend) == (world == 1), f"{spec}: {backend}")
        expect = ref["launches"]
        for r, rank in run["ranks"].items():
            check(rank["launches"] == expect,
                  f"{spec} rank {r} launched {rank['launches']}, one device {expect}")
        launches[spec] = {r: rank["launches"] for r, rank in run["ranks"].items()}
        if model == "FREEDOM":
            want = torch.load(ref["state"], map_location="cpu", weights_only=True)
            got = torch.load(run["state"], map_location="cpu", weights_only=True)
            same = {k: same_bits(got[k], want[k]) for k in want}
            check(loss == ref["loss"] and lists == ref["lists"] and all(same.values()),
                  f"{spec}: loss {loss!r} vs {ref['loss']!r}, rank lists {lists == ref['lists']}"
                  f", checkpoint {same}")
            verdict = (f"bit-equal to one device: loss {loss!r}, rank lists sha256 "
                       f"{lists[:16]}, checkpoint (" + ", ".join(same) + ")")
        else:
            rel = abs(loss - ref["loss"]) / abs(ref["loss"])
            check(rel <= MESH_LOSS_RTOL, f"{spec}: loss {loss!r} vs {ref['loss']!r}")
            split = split_lists(args, model, fds, device, run["state"], ref["state"])
            check(split["sha"] == lists, f"{spec}: its params rank to other lists here")
            overlap = top_share(split["rank_list"], ref["rank_list"])
            differ = int((split["rank_list"] != ref["rank_list"]).any(1).sum())
            cfg, _ = path_config(model, args)
            perm = permuted_epoch(cfg, fds, device)
            want = torch.load(ref["state"], map_location="cpu", weights_only=True)["params"]
            perm_drift = param_drift(perm["params"], want)
            perm_overlap = top_share(perm["rank_list"], ref["rank_list"])
            perm_differ = int((perm["rank_list"] != ref["rank_list"]).any(1).sum())
            bound = MESH_DRIFT_FACTOR * max(perm_drift.values())
            say("mesh", f"phase {phase}: {model} one epoch on one device with each batch's rows "
                f"permuted: loss {perm['loss']!r} (rel "
                f"{abs(perm['loss'] - ref['loss']) / abs(ref['loss']):.2e}); params vs one "
                f"device's: " + ", ".join(f"{k} {v:.3e}" for k, v in perm_drift.items())
                + f"; {perm_differ} users' lists differ, mean overlap {perm_overlap:.5f}")
            check(overlap >= TOPK_AGREE_MIN, f"{spec}: rank lists overlap {overlap:.4f}")
            check(max(split["drift"].values()) <= bound,
                  f"{spec}: params {split['drift']} from one device's, past {bound:.3e}")
            verdict = (f"loss {loss!r} vs one device {ref['loss']!r} (rel {rel:.2e}, "
                       f"bound {MESH_LOSS_RTOL:g}); rank lists {'equal' if lists == ref['lists'] else 'differ'}: "
                       f"{differ} of {len(ref['rank_list'])} users' top-"
                       f"{ref['rank_list'].shape[1]} lists differ, mean overlap {overlap:.5f} "
                       f"(bound {TOPK_AGREE_MIN}); the rank 0 checkpoint's params rank to "
                       f"the logged lists here; params vs one device's: "
                       + ", ".join(f"{k} {v:.3e}" for k, v in split["drift"].items())
                       + f" (bound {bound:.3e}: {MESH_DRIFT_FACTOR:g}x the permuted run's "
                       f"largest); replicated params sha256 {replicated[:16]} on both ranks")
        say("mesh", f"phase {phase}: {model} --mesh_shape {spec} through the CLI's spawn, 1 "
            f"epoch, {run['seconds']:.1f} s (one device's run {ref['seconds']:.1f} s); "
            f"{backend.split('; ')[-1]}; {verdict}")
        say("mesh", f"phase {phase}: peak device memory by rank "
            + ", ".join(f"{r}: {v['peak_gib']:.3f} GiB" for r, v in run["ranks"].items())
            + f" (one device {ref['peak_gib']:.3f} GiB); launches a rank "
            + f"{ {k: v for k, v in expect.items() if v} } (one device's)")
    return time.perf_counter() - t_start, k1, k2, launches


# Phases 73-79: the large catalogs, where the size gates that both packages
# share pick other branches than at baby, sports and beauty: microlens
# (46420 x 14079 = 653.5 M cells, above dense_prop_threshold's 600 M: the
# segment graph and no combined operator; GUME's bf16 budget of 8e8 keeps its
# dense bf16 R) and electronics (150179 x 51901: the user co-occurrence's
# sparse path above 1.5 B cells, BSPM's randomized SVD above 20000 items, a
# ranking pass over 150179 users). Synthetic sets of their exact shapes,
# each model at its Model_YAML file's first combo.
MICROLENS, ELECTRONICS = "microlens", "electronics"
CATALOG_LENS = (5, 14)  # train items a user, synthetic_dataset's default
CATALOG_CHUNK = 4096  # users a Gumbel top-k draw takes at once on the card
CATALOG_EPOCHS = {("LightGCN", MICROLENS): 2, ("SGL", MICROLENS): 1, ("GUME", MICROLENS): 1,
                  ("LightGCN", ELECTRONICS): 1, ("DualGNN", ELECTRONICS): 1}
# BSPM's electronics run keeps this many users: its dense fp32 R (U, I) and
# C = R^T R would be 31.2 GB and 0.8 PFLOP at all 150179; the items, whose
# count picks the branch, are all kept
BSPM_USERS = 30000
CATALOG_CHILD_TIMEOUT_S = 1000  # phases 73-78's child, from its start before phase 34
SGL_TAU = 0.1  # SGL's first combo's ssl_temp: K2's temperature at both catalogs' shapes


def catalog_dataset(name: str, seed: int, device, features: bool = False, shape=None):
    """``name``'s shape (or ``shape``, (users, items)) with
    ``synthetic_dataset``'s item weighting (w ~ 1 / (rank + 10), permuted)
    and CATALOG_LENS train items a user, drawn as a Gumbel top-k a chunk of
    users on ``device``: the first n of a row's largest log w + Gumbel keys
    are n items drawn without replacement with probabilities ~ w, the law of
    ``rng.choice(p=w, replace=False)`` without its pass over every item for
    each user; one val and one test item each, uniform over the items the
    user has not seen; with ``features``, the loader's synthetic image and
    text features (``data/loading.synthetic_item_features``)."""
    from chaorec_tpu_torch.data.loading import (DATASET_STATS, T_FEAT_DIM, T_FEAT_SEED,
                                                V_FEAT_DIM, V_FEAT_SEED, PaddedLists, RecDataset,
                                                synthetic_item_features)

    num_user, num_item = shape or DATASET_STATS[name]
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(num_item) + 10.0)
    w = w[rng.permutation(num_item)]
    lens = rng.integers(*CATALOG_LENS, num_user)
    width = int(lens.max())
    log_w = torch.from_numpy(np.log(w)).to(device, torch.float32)
    gen = torch.Generator(device).manual_seed(seed)
    picks = []
    for start in range(0, num_user, CATALOG_CHUNK):
        u = torch.rand((min(CATALOG_CHUNK, num_user - start), num_item), generator=gen,
                       device=device)
        picks.append(torch.topk(log_w - torch.log(-torch.log(u)), width, dim=1).indices.cpu())
    picks = torch.cat(picks).numpy().astype(np.int32)
    kept = np.arange(width)[None, :] < lens[:, None]
    edges = np.stack([np.repeat(np.arange(num_user, dtype=np.int32), lens), picks[kept]], 1)
    hist = np.sort(np.where(kept, picks, num_item), axis=1).astype(np.int32)
    held = unseen_pairs(rng, hist, num_item).astype(np.int32)
    users, ones = np.arange(num_user, dtype=np.int32), np.ones(num_user, np.int32)
    feats = {}
    if features:
        feats = dict(
            v_feat=synthetic_item_features(edges, num_user, num_item, V_FEAT_DIM, V_FEAT_SEED),
            t_feat=synthetic_item_features(edges, num_user, num_item, T_FEAT_DIM, T_FEAT_SEED))
    return RecDataset(
        name=name, num_user=num_user, num_item=num_item, train_edges=edges,
        history=PaddedLists(hist, lens.astype(np.int32), num_item),
        val_users=users, val_pos=PaddedLists(held[:, :1].copy(), ones, -1),
        test_users=users, test_pos=PaddedLists(held[:, 1:].copy(), ones, -1), **feats)


def unseen_pairs(rng, hist: np.ndarray, num_item: int, cands: int = 8) -> np.ndarray:
    """(U, 2): two distinct items a user, each uniform over the items not in
    its row of ``hist`` (U, H) (rejection from ``cands`` uniform draws a
    row; a row left with fewer than two draws again)."""
    out = np.empty((hist.shape[0], 2), np.int64)
    todo = np.arange(hist.shape[0])
    while todo.size:
        cand = rng.integers(num_item, size=(todo.size, cands))
        bad = (cand[:, :, None] == hist[todo][:, None, :]).any(2)
        bad |= np.triu(cand[:, :, None] == cand[:, None, :], 1).any(1)  # an earlier draw's twin
        ok = ~bad
        enough = ok.sum(1) >= 2
        first = np.argsort(bad, axis=1, kind="stable")[:, :2]
        out[todo[enough]] = np.take_along_axis(cand, first, 1)[enough]
        todo = todo[~enough]
    return out


def first_users(ds, n: int):
    """``ds`` cut to its first ``n`` users: their edges, histories and held
    items; every item kept."""
    from chaorec_tpu_torch.data.loading import PaddedLists

    def rows(p):
        return PaddedLists(p.values[:n], p.lengths[:n], p.fill)

    keep = ds.train_edges[:, 0] < n
    return dataclasses.replace(
        ds, num_user=n, train_edges=ds.train_edges[keep], history=rows(ds.history),
        val_users=ds.val_users[:n], val_pos=rows(ds.val_pos), test_users=ds.test_users[:n],
        test_pos=rows(ds.test_pos))


def catalog_set(args, name: str, device, features: bool = False):
    """``name``'s set: ``--data_root``'s, or ``catalog_dataset``'s; its
    seconds printed."""
    from chaorec_tpu_torch.data.loading import data_load

    t0 = time.perf_counter()
    ds = (data_load(name, args.data_root, has_v=features, has_t=features) if args.data_root
          else catalog_dataset(name, args.seed, device, features))
    say("catalog", f"{'data_load' if args.data_root else 'synthetic'} {name} ({ds.num_user}, "
        f"{ds.num_item}) = {ds.num_user * ds.num_item / 1e6:.1f} M cells, {ds.num_edges} train "
        f"edges{', 4096- and 384-wide features' if features else ''}: "
        f"{time.perf_counter() - t0:.2f} s")
    return ds


class RankProbe:
    """While active, times each ranking pass of the trainer's evaluation
    (``train/loop.sharded_rank``, the device synchronized at both ends) with
    its peak device memory above what was allocated before it (the peak
    before it, the training's, is kept in ``before``), and records the
    shape of every score block ``eval/ranking.mask_and_topk`` masks."""

    def __enter__(self):
        from chaorec_tpu_torch.eval import ranking
        from chaorec_tpu_torch.train import loop

        self.ranking, self.loop = ranking, loop
        rank, mask = self.orig = loop.sharded_rank, ranking.mask_and_topk
        self.passes, self.blocks = [], set()

        def timed(*a, **kw):
            torch.cuda.synchronize()
            before, base = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = rank(*a, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            self.passes.append(dict(seconds=time.perf_counter() - t0, before_gib=before / 2 ** 30,
                                    peak_gib=(peak - base) / 2 ** 30, abs_gib=peak / 2 ** 30))
            return out

        def seen(scores, *a, **kw):
            self.blocks.add(tuple(scores.shape))
            return mask(scores, *a, **kw)

        loop.sharded_rank, ranking.mask_and_topk = timed, seen
        return self

    def __exit__(self, *exc):
        self.loop.sharded_rank, self.ranking.mask_and_topk = self.orig

    def run_peak_gib(self) -> float:
        """The peak device memory of the training epochs and ranking passes."""
        return max(max(p["before_gib"], p["abs_gib"]) for p in self.passes)

    def report(self, phase: str, ds, chunk: int) -> None:
        """Prints each pass and checks that no score block was wider than
        ``chunk`` users by the catalog: no (U, I) tensor."""
        cells = ds.num_user * ds.num_item
        for i, p in enumerate(self.passes):
            say(phase, f"ranking pass {i + 1} over {ds.num_user} users x {ds.num_item} items: "
                f"{p['seconds']:.3f} s ({ds.num_user / p['seconds']:.0f} users/s), peak "
                f"{p['peak_gib']:.3f} GiB above what was allocated before it (the training's "
                f"peak before it {p['before_gib']:.2f} GiB; a whole (U, I) fp32 score table "
                f"would be {cells * 4 / 2 ** 30:.1f} GiB); score blocks masked "
                f"{sorted(self.blocks)}")
        check(self.passes and all(b[0] <= chunk and b[1] == ds.num_item for b in self.blocks)
              and all(p["peak_gib"] < cells * 4 / 2 ** 30 for p in self.passes),
              f"ranking held more than a chunk of scores: {sorted(self.blocks)}, {self.passes}")


class CallProbe:
    """While active, counts and times each call of ``module.name`` (the
    device synchronized at both ends; with ``host_peak``, the peak of what
    tracemalloc sees numpy and scipy allocate on the host during the call,
    above what was traced at its start)."""

    def __init__(self, module, name: str, host_peak: bool = False):
        self.module, self.name, self.host_peak = module, name, host_peak
        self.calls = []

    def __enter__(self):
        import tracemalloc

        fn = self.orig = getattr(self.module, self.name)

        def counted(*a, **kw):
            if self.host_peak:
                tracemalloc.start()
                base = tracemalloc.get_traced_memory()[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            finally:
                seconds = time.perf_counter() - t0
                peak = 0.0
                if self.host_peak:
                    peak = (tracemalloc.get_traced_memory()[1] - base) / 2 ** 30
                    tracemalloc.stop()
            self.calls.append(dict(seconds=seconds, host_peak_gib=peak))
            return out

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


CATALOG_GROUPS = {
    "index_add_ and the gathers' backward (deterministic: indexing_backward_kernel, its sort)": (
        "indexing_backward", "radix", "sort"),
    "gathers (index_select)": ("index_select", "indexselect", "gather"),
    "GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90"),
    "K2 (streaming logsumexp)": ("lse_",),
    "copies (dtype casts: bdot's fp32 copies of a bf16 graph among them)": ("copy",),
    "elementwise": ("elementwise",),
    "reductions": ("reduce_kernel",)}


def catalog_step_profile(phase: str, name: str, model, ds, cfg, out_dir: str) -> tuple:
    """One training step of ``model`` on ``ds`` under the profiler (device
    time by kernel group, idle share) and its peak device memory. Returns
    (wall ms, device ms, the steps taken: ``device_profile``'s two unprofiled
    calls and its profiled tries)."""
    from chaorec_tpu_torch.train.loop import Trainer

    trainer = Trainer(model, ds, cfg)
    params = trainer.init_params()
    opt = trainer.make_optimizer(params)
    model.pre_epoch(params, 0)
    batch = first_batch(trainer, cfg)
    steps = []

    def step():
        steps.append(1)
        trainer.train_step(params, opt, batch)

    torch.cuda.reset_peak_memory_stats()
    wall_ms, busy_ms = device_profile(
        phase, f"one {name} training step of {cfg.batch_size} edges at {ds.name} "
        f"({ds.num_user} x {ds.num_item}; forward, backward, Adam)", step,
        os.path.join(out_dir, f"chip_smoke_{name.lower()}_{ds.name}_step.txt"),
        groups=CATALOG_GROUPS)
    say(phase, f"{name} step peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB")
    del trainer, params, opt, batch
    return wall_ms, busy_ms, len(steps)


def catalog_cli_run(phase: str, args, device, ds, name: str, lse_terms: int = 0,
                    export: str = "", probes=()):
    """``name`` at its first combo, its CATALOG_EPOCHS on ``ds``, through
    ``linear_cli_run`` on ``ds`` (its launches checked: K2 ``lse_terms``
    times a step, the CSR gather-sum by ``csr_sums``, nothing else), with
    the ranking passes probed. Returns (model, RankProbe, the run's
    wall seconds, its K2 launches, its CSR gather-sum launches)."""
    from chaorec_tpu_torch.config import Config
    from chaorec_tpu_torch.ops.csr_spmm import csr_spmm

    combo, grid = first_combo(name)
    cfg = Config(Model=name, data_path=ds.name, seed=args.seed).replace(**combo).replace(
        num_epoch=CATALOG_EPOCHS[name, ds.name], log_dir=args.out_dir, export_artifact=export)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        ranks = stack.enter_context(RankProbe())
        for p in probes:
            stack.enter_context(p)
        models, _ = linear_cli_run(phase, device, ds, name, cfg, grid, lse_terms=lse_terms)
    run_s = time.perf_counter() - t0
    k2, n_csr = lse_counts(), csr_spmm.launches
    model = models[0]
    check(len(models) == 1 and model.device.type == device.type, f"{name} is not on the card")
    ranks.report(phase, ds, cfg.eval_user_chunk)
    return model, cfg, ranks, run_s, k2, n_csr


def catalog_summary(phase: str, number: int, name: str, ds, run_s: float, peak_gib: float,
                    branch: str, launches) -> None:
    say(phase, f"phase {number} {name} at {ds.name} ({ds.num_user} x {ds.num_item}): wall "
        f"{run_s:.1f} s, peak device memory {peak_gib:.2f} GiB, branch: {branch}; kernel "
        f"launches {launches}")


def describe_graph(graph) -> str:
    if graph.use_dense:
        return (f"the dense {graph.compute_dtype} R {tuple(graph.dense_r.shape)}, "
                f"{graph.dense_r.numel() * graph.dense_r.element_size() / 1e9:.2f} GB")
    return (f"the segment graph ({graph.num_edges} edges by user and by item, the CSR "
            f"gather-sum; no dense R)")


def k2_catalog_holds(phase: str, gen, device, sides: dict, errs: dict) -> dict:
    """K2 at (1024, n, 64) for each of ``sides`` ({side: n}), SGL's
    temperature: the forward, dq and dk against the plain version and its
    autograd at phase 3's gates, then each kernel timed beside the plain
    version, the library route and its bound. Returns {side: timings}."""
    out = {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for side, n in sides.items():
        shape = (1024, n, 64, SGL_TAU, True)
        lse_hold(gen, device, shape, errs, phase)
        q, k, g = lse_inputs(gen, shape, device)
        out[side] = lse_timings(phase, side, q.detach(), k.detach(), g, True, sms)
        del q, k, g
        torch.cuda.empty_cache()
    return out


class CatalogChild:
    """Phases 73-78 in a child process (``chip_smoke.py --catalog_child``):
    their CLI runs at the large catalogs, started before phase 34, run
    beside phases 34-72 (DualGNN's co-occurrence build alone is minutes of
    one host core); ``catalog_phases`` collects it. An exit of this
    interpreter ends it."""

    def __init__(self, args):
        self.dir = os.path.abspath(os.path.join(args.out_dir, "catalog"))
        os.makedirs(self.dir, exist_ok=True)
        self.result = os.path.join(self.dir, "catalog.json")
        self.out = os.path.join(self.dir, "child.txt")
        cmd = [sys.executable, os.path.abspath(__file__), "--catalog_child", self.result,
               "--seed", str(args.seed), "--out_dir", self.dir]
        if args.data_root:
            cmd += ["--data_root", os.path.abspath(args.data_root)]
        atexit.register(self.stop)
        with open(self.out, "w") as fh:
            self.t0 = time.perf_counter()
            self.proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        self.waiter = ThreadPoolExecutor(1)
        self.end = self.waiter.submit(lambda: (self.proc.wait(), time.perf_counter()))

    def collect(self) -> dict:
        """The child's lines (printed here) and its result, once it has
        ended; its wall from start to end."""
        rc, end = self.end.result(timeout=CATALOG_CHILD_TIMEOUT_S)
        self.waiter.shutdown()
        with open(self.out) as fh:
            lines = fh.read().splitlines()
        for line in lines:
            print(line, flush=True)
        check(rc == 0, f"phases 73-78's child exited {rc}: " + "\n".join(lines[-30:]))
        with open(self.result) as fh:
            return dict(json.load(fh), child_s=end - self.t0)

    def stop(self) -> None:
        if self.proc.poll() is None:
            kill_tree(self.proc.pid)
            self.proc.wait()


def microlens_phases(args, device) -> dict:
    """Phases 73-75 on the microlens-sized set (U x I above
    dense_prop_threshold): (73) LightGCN, 2 epochs on the segment graph with
    no combined operator, exported and served; (74) SGL, 1 epoch there, its
    K2 launches counted; (75) GUME, 1 epoch on its dense bf16 R (the 8e8
    budget), its fp32 copies in bdot's backward timed; each step profiled.
    Returns {"sgl_k2": SGL's (fwd, dq, dk) launches, "csr": the CSR
    gather-sum's launches by phase}."""
    from chaorec_tpu_torch.config import Config

    phase = "catalog"
    thr = Config().dense_prop_threshold
    csr = {}
    mds = catalog_set(args, MICROLENS, device, features=True)  # GUME reads the features
    # 73. LightGCN at microlens: the segment graph, no operator -------------
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "lightgcn_microlens.npz")
        model, cfg, ranks, run_s, _, cli_csr = catalog_cli_run(phase, args, device, mds,
                                                               "LightGCN", export=art)
        peak = ranks.run_peak_gib()
        check(mds.num_user * mds.num_item > thr and not model.graph.use_dense
              and model.graph.dense_r is None and model.linear_op is None,
              "LightGCN at microlens is not on the segment graph without an operator")
        reset_counts()
        check_embeddings_serving(phase, art, mds, device, "LightGCN")
        steps = catalog_step_profile(phase, "LightGCN", model, mds, cfg, args.out_dir)[2]
        csr[73] = dict(model="LightGCN", sums=csr_sums(model), cli=cli_csr, steps=steps,
                       step=check_step_launches(phase, model, steps))
        catalog_summary(phase, 73, "LightGCN", mds, run_s, peak,
                        f"U x I {mds.num_user * mds.num_item / 1e6:.1f} M > dense_prop_threshold "
                        f"{thr / 1e6:.0f} M: {describe_graph(model.graph)}, no combined operator",
                        f"csr_spmm {cli_csr} in the run, {csr[73]['step']} in {steps} profiled "
                        f"steps; no other kernel (expected none)")
        del model
        gc.collect()
        torch.cuda.empty_cache()

    # 74. SGL at microlens: the segment graph, K2 two terms a step ----------
    model, cfg, ranks, run_s, sgl_k2, cli_csr = catalog_cli_run(phase, args, device, mds, "SGL",
                                                                lse_terms=2)
    peak = ranks.run_peak_gib()
    check(not model.graph.use_dense, "SGL at microlens is not on the segment graph")
    reset_counts()
    steps = catalog_step_profile(phase, "SGL", model, mds, cfg, args.out_dir)[2]
    k2_steps = lse_counts()
    check(k2_steps == (2 * steps,) * 3, f"SGL's {steps} profiled steps launched K2 {k2_steps}")
    csr[74] = dict(model="SGL", sums=csr_sums(model), cli=cli_csr, steps=steps,
                   step=check_step_launches(phase, model, steps, *kernel_wrappers()[3:6]))
    catalog_summary(phase, 74, "SGL", mds, run_s, peak, describe_graph(model.graph),
                    f"streaming_lse fwd/dq/dk {sgl_k2} (2 terms a step, each with all three), "
                    f"csr_spmm {cli_csr} in the run, {csr[74]['step']} in {steps} profiled steps")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 75. GUME at microlens: the dense bf16 R under its 8e8 budget ----------
    model, cfg, ranks, run_s, _, _ = catalog_cli_run(phase, args, device, mds, "GUME")
    peak = ranks.run_peak_gib()
    r = model.r_norm
    check(model.graph_bf16 and r.dtype == torch.bfloat16 and tuple(r.shape) == (
        mds.num_user, mds.num_item) and mds.num_user * mds.num_item <= model.dense_entry_budget,
          "GUME at microlens is not on its dense bf16 R")
    reset_counts()
    wall_ms, busy_ms, _ = catalog_step_profile(phase, "GUME", model, mds, cfg, args.out_dir)
    n_r = 2 * model.n_ui_layers + 1
    n_ii = model.n_ui_layers + 2 * model.n_layers
    r_ms = cuda_ms(lambda: model.r_norm.float(), 5)
    ii_ms = cuda_ms(lambda: model.ii_norm.float(), 5)
    copies_ms = n_r * r_ms + n_ii * ii_ms
    say(phase, f"GUME's fp32 copies of its bf16 graphs in bdot's backward: {n_r} of R "
        f"{tuple(r.shape)} ({r.numel() * 2 / 1e9:.2f} GB in bf16) at {r_ms:.3f} ms and {n_ii} of "
        f"an (I, I) graph at {ii_ms:.3f} ms, timed alone: {copies_ms:.2f} ms a step, "
        f"{100 * copies_ms / busy_ms:.1f}% of its device time ({busy_ms:.1f} ms), "
        f"{100 * copies_ms / wall_ms:.1f}% of its wall ({wall_ms:.1f} ms)")
    check(not any(other_counts()), f"GUME's step launched {other_counts()}")
    catalog_summary(phase, 75, "GUME", mds, run_s, peak,
                    f"U x I {mds.num_user * mds.num_item / 1e6:.1f} M <= its bf16 budget "
                    f"{model.dense_entry_budget / 1e6:.0f} M: the dense bf16 R "
                    f"{tuple(r.shape)}, {r.numel() * 2 / 1e9:.2f} GB", "none (expected none)")
    del model, r, mds
    gc.collect()
    torch.cuda.empty_cache()
    return {"sgl_k2": list(sgl_k2), "csr": csr}


def electronics_phases(args, device) -> dict:
    """Phases 76-78 on the electronics-sized set (with the loader's
    synthetic features): (76) LightGCN, 1 epoch, every user ranked a chunk
    at a time, exported and served; (77) DualGNN, 1 epoch, its user
    co-occurrence graph on the sparse path (timed, with the host's peak);
    (78) BSPM on the set's first BSPM_USERS users, its randomized SVD, one
    scoring pass; the trained models' steps profiled. Returns the CSR
    gather-sum's launches by phase."""
    from chaorec_tpu_torch.config import Config
    from chaorec_tpu_torch.graphs import user_graph
    from chaorec_tpu_torch.models import bspm

    phase = "catalog"
    csr = {}
    eds = catalog_set(args, ELECTRONICS, device, features=True)
    # 76. LightGCN at electronics: every user ranked a chunk at a time ------
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "lightgcn_electronics.npz")
        model, cfg, ranks, run_s, _, cli_csr = catalog_cli_run(phase, args, device, eds,
                                                               "LightGCN", export=art)
        peak = ranks.run_peak_gib()
        check(not model.graph.use_dense and model.linear_op is None,
              "LightGCN at electronics is not on the segment graph without an operator")
        reset_counts()
        check_embeddings_serving(phase, art, eds, device, "LightGCN")
        steps = catalog_step_profile(phase, "LightGCN", model, eds, cfg, args.out_dir)[2]
        csr[76] = dict(model="LightGCN", sums=csr_sums(model), cli=cli_csr, steps=steps,
                       step=check_step_launches(phase, model, steps))
        catalog_summary(phase, 76, "LightGCN", eds, run_s, peak,
                        f"{describe_graph(model.graph)}, no combined operator; ranking "
                        f"{cfg.eval_user_chunk} users a block",
                        f"csr_spmm {cli_csr} in the run, {csr[76]['step']} in {steps} profiled "
                        f"steps; no other kernel (expected none)")
        del model
        gc.collect()
        torch.cuda.empty_cache()

    # 77. DualGNN at electronics: the co-occurrence graph's sparse path -----
    dense_cells = inspect.signature(user_graph.build_user_cooccurrence).parameters[
        "dense_threshold"].default
    sparse = CallProbe(user_graph, "_build_user_cooccurrence_sparse", host_peak=True)
    with UserGraphProbe() as uu:
        model, cfg, ranks, run_s, _, cli_csr = catalog_cli_run(phase, args, device, eds,
                                                               "DualGNN", probes=(sparse,))
    peak = ranks.run_peak_gib()
    build = uu.builds[0]
    check(len(sparse.calls) == 1 and eds.num_user * eds.num_item > dense_cells,
          f"DualGNN's co-occurrence took the sparse path {len(sparse.calls)} times")
    idx, cnt, lengths = model._uu
    say(phase, f"DualGNN's user co-occurrence graph: U x I = {eds.num_user * eds.num_item / 1e9:.2f}"
        f" B cells > the dense threshold {dense_cells / 1e9:.1f} B: the sparse path (scipy, "
        f"A A^T a 4096-user chunk at a time, each row ordered by (-count, id)) "
        f"{sparse.calls[0]['seconds']:.1f} s of host, host peak "
        f"{sparse.calls[0]['host_peak_gib']:.2f} GiB above its start (tracemalloc), the build "
        f"{build['seconds']:.1f} s in all; {idx.shape[1]} neighbours kept, {int(lengths.sum())} "
        f"in all; topk_sample (numpy, user by user) on the host "
        + ", ".join(f"{s:.3f}" for s in uu.samples) + " s (construction, then each epoch's "
        "pre_epoch)")
    check(bool(np.isfinite(cnt).all()) and int(lengths.max()) <= idx.shape[1]
          and bool((cnt[:, :-1] >= cnt[:, 1:]).all()), "DualGNN's co-occurrence graph is malformed")
    reset_counts()
    steps = catalog_step_profile(phase, "DualGNN", model, eds, cfg, args.out_dir)[2]
    csr[77] = dict(model="DualGNN", sums=csr_sums(model), cli=cli_csr, steps=steps,
                   step=check_step_launches(phase, model, steps))
    catalog_summary(phase, 77, "DualGNN", eds, run_s, peak,
                    f"{describe_graph(model.graph)}; the sparse co-occurrence path",
                    f"csr_spmm {cli_csr} in the run, {csr[77]['step']} in {steps} profiled "
                    f"steps; no other kernel (expected none)")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 78. BSPM at electronics' items: the randomized SVD --------------------
    cut = first_users(eds, min(BSPM_USERS, eds.num_user))
    combo, grid = first_combo("BSPM")
    bspm._SPECTRAL_CACHE.clear()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, CallProbe(bspm, "randomized_svd") as rsvd:
        cfg = Config(Model="BSPM", data_path=ELECTRONICS, seed=args.seed).replace(
            **combo).replace(log_dir=args.out_dir, export_artifact=os.path.join(tmp, "bspm.npz"))
        model, k2 = family_cli_run(device, cut, "BSPM", cfg, grid)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(cut.num_item > bspm.EIGSH_MAX_ITEMS and len(rsvd.calls) == 1
          and tuple(model.b.shape) == (cut.num_item, model.factor_dim),
          f"BSPM at {cut.num_item} items took another branch ({len(rsvd.calls)} SVDs)")
    say(phase, f"BSPM on the first {cut.num_user} of {eds.num_user} users (all {cut.num_item} "
        f"items, {cut.num_edges} edges): R {cut.num_user * cut.num_item * 4 / 1e9:.2f} GB fp32, "
        f"C = R^T R {cut.num_item ** 2 * 4 / 1e9:.2f} GB; the randomized SVD of R "
        f"{rsvd.calls[0]['seconds']:.3f} s of the spectral build {model.build_seconds:.3f} s")
    catalog_summary(phase, 78, "BSPM", cut, run_s, peak,
                    f"{cut.num_item} items > {bspm.EIGSH_MAX_ITEMS}: the randomized SVD "
                    f"(oversample 128, 8 power iterations), B {tuple(model.b.shape)}",
                    f"{tuple(k2)} of K2 (expected none)")
    del model, cut, eds
    bspm._SPECTRAL_CACHE.clear()
    return csr


def catalog_child_main(args, device) -> int:
    """Phases 73-78, run by ``--catalog_child``: ``microlens_phases``, then
    ``electronics_phases``. Writes the result's JSON (SGL's K2 launches, the
    CSR gather-sum's launches by phase) to ``args.catalog_child``."""
    result = microlens_phases(args, device)
    gc.collect()
    torch.cuda.empty_cache()
    result["csr"].update(electronics_phases(args, device))
    with open(args.catalog_child, "w") as fh:
        json.dump(result, fh)
    return 0


def catalog_phases(args, device, child: CatalogChild) -> tuple:
    """Phases 73-79: the two large catalogs. Phases 73-78 ran in ``child``
    (each printing its wall, peak memory, branch and launches; collected
    here, their lines printed); then K2 at SGL's two microlens shapes
    (phase 74's kernels) and at electronics' two sides (79), held and
    timed here. Returns (seconds, SGL's K2 launches, K2 at microlens, K2 at
    electronics, the child's result)."""
    from chaorec_tpu_torch.data.loading import DATASET_STATS

    t_start = time.perf_counter()
    phase = "catalog"
    result = child.collect()
    say(phase, f"phases 73-78's child (started before phase 34, beside phases 34-72): "
        f"{result['child_s']:.1f} s from its start to its end")
    gen = torch.Generator(device=device).manual_seed(args.seed + 73)
    errs = {"fwd": 0.0, "dq": 0.0, "dk": 0.0}
    sides = {}
    for name in (MICROLENS, ELECTRONICS):
        num_user, num_item = DATASET_STATS[name]
        sides[name] = k2_catalog_holds(phase, gen, device, {"user": num_user, "item": num_item},
                                       errs)
    say(phase, f"K2 at the catalogs' shapes against the plain version: max abs err fwd "
        f"{errs['fwd']:.3e}, dq {errs['dq']:.3e}, dk {errs['dk']:.3e}")
    return (time.perf_counter() - t_start, tuple(result["sgl_k2"]),
            dict(sides[MICROLENS], max_abs_err=errs), dict(sides[ELECTRONICS], max_abs_err=errs),
            result)


CSR_WIDTHS = (64, 45)  # the benchmark's dim_E, and an odd width (a partial column tile)
CSR_CHAIN_CYCLES = 4  # cycles of one dependent fp32 add: a row's sum is a chain of them


def sm_max_mhz() -> float:
    """The card's highest SM clock (nvidia-smi), for a chain's bound."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True)
    return float(out.stdout.split()[0])


def csr_spmm_phases(args, device) -> dict:
    """Phase 80: the segment graph's CSR gather-sum (``csrc/csr_spmm.cu``)
    on the microlens and electronics catalogs' graphs (``catalog_set``), at
    D 64 and 45: each call of a training step (apply_r and apply_rt forward
    at fp32 and from a bf16 copy, and their input gradients, the fp32
    cotangent unrounded) held bit for bit to its plain version
    (``csr_spmm_reference``) and to the parent path (the gather, the product
    and the deterministic ``index_add_``, or the gather's ``index_put_``
    with accumulate, its backward), then timed (20 calls back to back, and
    as a CUDA graph) beside its bounds (bytes: each gathered row once an
    edge, the ids and weights, the output; and the hottest row's chain of
    dependent adds), the plain version and the parent path (the library
    yardstick), both 3 calls under the deterministic mode. Returns
    {catalog: {call: timings}} at D 64."""
    from chaorec_tpu_torch.graphs.norm_adj import build_norm_adj
    from chaorec_tpu_torch.ops.csr_spmm import csr_spmm, csr_spmm_reference
    from chaorec_tpu_torch.train.loop import deterministic_mode

    phase = "csr"
    mhz = sm_max_mhz()
    gen = torch.Generator(device=device).manual_seed(args.seed + 80)
    out = {}
    for name in (MICROLENS, ELECTRONICS):
        ds = catalog_set(args, name, device)
        g = build_norm_adj(ds.train_edges, ds.num_user, ds.num_item, device, use_dense=False)
        e = g.num_edges
        # (call, rows, the gathered table's rows, CSR, the parent's (dst, src,
        # w), a bf16 input, the parent's form is the gather's backward)
        by_u, by_i = (g.u_by_u, g.i_by_u, g.w_by_u), (g.i_by_i, g.u_by_i, g.w_by_i)
        grad_r, grad_rt = (g.i_by_u, g.u_by_u, g.w_by_u), (g.u_by_i, g.i_by_i, g.w_by_i)
        calls = (("fwd_r", g.num_user, g.num_item, g.csr_r, by_u, False, False),
                 ("fwd_r_bf16", g.num_user, g.num_item, g.csr_r, by_u, True, False),
                 ("fwd_rt", g.num_item, g.num_user, g.csr_rt, by_i, False, False),
                 ("fwd_rt_bf16", g.num_item, g.num_user, g.csr_rt, by_i, True, False),
                 ("bwd_r", g.num_item, g.num_user, g.csr_r_grad, grad_r, False, True),
                 ("bwd_rt", g.num_user, g.num_item, g.csr_rt_grad, grad_rt, False, True))
        out[name] = {}
        for d in CSR_WIDTHS:
            for call, n_rows, n_src, csr, (dst, src, w), bf16, backward in calls:
                x = torch.randn((n_src, d), generator=gen, device=device)
                xin = x.to(torch.bfloat16) if bf16 else x
                xp = xin.float()

                def parent():
                    # forward: zeros.index_add_(dst, w x[src]); the gather's
                    # backward: zeros.index_put_(src, w g[dst], accumulate)
                    msgs = w[:, None] * xp[src]
                    z = torch.zeros((n_rows, d), device=device)
                    if backward:
                        return z.index_put_((dst,), msgs, accumulate=True)
                    return z.index_add_(0, dst, msgs)

                before = csr_spmm.launches
                got = csr_spmm(xin, csr)
                torch.cuda.synchronize()
                check(csr_spmm.launches == before + 1, f"csr_spmm {name} {call} did not launch")
                with deterministic_mode():
                    want, plain = parent(), csr_spmm_reference(xin, csr)
                check(torch.equal(got, want) and torch.equal(got, plain),
                      f"csr_spmm {name} {call} D {d}: bits differ from the parent path "
                      f"({(got - want).abs().max().item():.3e}) or the plain version "
                      f"({(got - plain).abs().max().item():.3e})")
                deg = int(csr.ptr[1] - csr.ptr[0])
                nbytes = e * d * xin.element_size() + 8 * e + n_rows * d * 4 + 8 * n_rows
                b_ms, by = bound_ms(2 * e * d, nbytes)
                chain_ms = deg * CSR_CHAIN_CYCLES / (mhz * 1e3)
                ms = cuda_ms(lambda: csr_spmm(xin, csr), 20)
                g_ms = graph_ms(lambda: csr_spmm(xin, csr))
                with deterministic_mode():
                    plain_ms = cuda_ms(lambda: csr_spmm_reference(xin, csr), 3)
                    parent_ms = cuda_ms(parent, 3)
                say(phase, f"{name} {call} ({n_rows} rows from ({n_src}, {d}) "
                    f"{'bf16' if bf16 else 'fp32'}, {e} edges, hottest row {deg}): bits equal "
                    f"the parent path's and the plain version's; kernel {ms:.4f} ms (graph "
                    f"{g_ms:.4f}), bound {b_ms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, the rows "
                    f"mostly from L2), chain {chain_ms:.4f} ms ({deg} adds x "
                    f"{CSR_CHAIN_CYCLES} cycles at {mhz:.0f} MHz), plain {plain_ms:.4f} ms, "
                    f"parent index_add_ {parent_ms:.4f} ms")
                if d == CSR_WIDTHS[0]:
                    out[name][call] = dict(shape=[n_rows, n_src, d, e], dtype="bfloat16" if bf16
                                           else "float32", ms=ms, graph_ms=g_ms, bound_ms=b_ms,
                                           bound_by=by, chain_ms=chain_ms, plain_ms=plain_ms,
                                           library_ms=parent_ms)
                del x, xin, xp, got, want, plain
        del ds, g
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_root", default="")
    ap.add_argument("--out_dir", default="log")
    ap.add_argument("--catalog_child", default="", help=argparse.SUPPRESS)  # phases 73-78
    args = ap.parse_args(argv)
    t_run = time.perf_counter()

    # 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    from chaorec_tpu_torch import cli, kernels
    from chaorec_tpu_torch.config import Config
    from chaorec_tpu_torch.data.loading import DATASET_STATS, data_load
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.models.base import Batch
    from chaorec_tpu_torch.models.cf_diff import CF_Diff
    from chaorec_tpu_torch.ops.fused_attn import (dropout_mask, fused_mha, fused_mha_bwd,
                                                  mha_reference, mha_reference_grads)
    from chaorec_tpu_torch.serve import Recommender, export_artifact
    from chaorec_tpu_torch.train.loop import deterministic_mode

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", smi)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # Full fp32 products, as the CPU tests that hold the port to JAX use.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", "tf32 off for matmul and cudnn")
    os.makedirs(args.out_dir, exist_ok=True)
    if args.catalog_child:
        return catalog_child_main(args, device)

    # 2. build: one nvcc per source, all at once --------------------------
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = list(pool.map(kernels.build, KERNELS))
    for built in builds:
        say("build", f"{built.name}: {built.seconds:.2f} s -> {built.path.name}")
        for line in built.log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                say("build", line.strip())

    # 3. kernels vs plain -----------------------------------------------
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def qkv(b, h, lq, lk, dh):
        return [torch.randn(shape, generator=gen, device=device)
                for shape in ((b, h, lq, dh), (b, h, lk, dh), (b, h, lk, dh))]

    seed_t = torch.tensor([args.seed * 7919 + 17], device=device)
    fwd_err = {1.0: 0.0, 0.5: 0.0}  # max abs error of the forward by keep_prob
    bwd_err = 0.0
    for keep in (1.0, 0.5):
        for shape in ATTN_SHAPES:
            q, k, v = qkv(*shape)
            got = fused_mha(q, k, v, seed_t, keep)
            torch.cuda.synchronize()
            err = (got - mha_reference(q, k, v, seed_t, keep)).abs().max().item()
            fwd_err[keep] = max(fwd_err[keep], err)
            check(err <= ATTN_TOL, f"fused_mha {shape} keep {keep}: max abs err {err} > {ATTN_TOL}")
            ms = cuda_ms(lambda: fused_mha(q, k, v, seed_t, keep))
            plain_ms = cuda_ms(lambda: mha_reference(q, k, v, seed_t, keep), 3)
            library = ""
            if keep == 1.0:  # one library call computes the same function only without dropout
                lib_ms, lib_out = sdpa_ms(q, k, v)
                bms, by = attn_bound(shape)
                library = (f", scaled_dot_product_attention {lib_ms:.4f} ms (max abs diff from the "
                           f"kernel {(lib_out - got).abs().max().item():.3e}), bound {bms:.4f} ms ({by})")
            say("kernel", f"fwd {shape} keep {keep}: max_abs_err {err:.3e} (bound {ATTN_TOL:g}), "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{library}")
    b, h, lq, lk, _ = BWD_SHAPES[0]
    kept = dropout_mask(seed_t, b * h, lq, lk, 0.5, device=device).float().mean().item()
    say("kernel", f"dropout keep 0.5: kept share {kept:.6f} of {b * h * lq * lk} weights "
        f"(4 sigma = {4 * math.sqrt(0.25 / (b * h * lq * lk)):.1e})")
    check(abs(kept - 0.5) <= 4 * math.sqrt(0.25 / (b * h * lq * lk)), "kept share is off")
    for keep in (1.0, 0.5):
        for shape in BWD_SHAPES:
            q, k, v = (t.requires_grad_() for t in qkv(*shape))
            dout = torch.randn(q.shape, generator=gen, device=device)
            before = fused_mha_bwd.launches
            got = torch.autograd.grad(fused_mha(q, k, v, seed_t, keep), (q, k, v), dout)
            torch.cuda.synchronize()
            check(fused_mha_bwd.launches == before + 1, "the backward kernel did not run")
            want = mha_reference_grads(q, k, v, dout, seed_t, keep)
            errs = [((a - w).abs().max() / w.abs().max()).item() for a, w in zip(got, want)]
            bwd_err = max(bwd_err, *[(a - w).abs().max().item() for a, w in zip(got, want)])
            say("kernel", f"bwd {shape} keep {keep}: dq, dk, dv max abs err / max |plain| "
                f"{errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e} (bound {BWD_REL_TOL:g})")
            check(max(errs) <= BWD_REL_TOL, f"fused_mha_bwd {shape} keep {keep} disagrees")
    del q, k, v, got, want, dout

    chunk = Config().eval_user_chunk
    q, k, v = qkv(chunk, 4, 1034, 1034, 4)
    got = fused_mha(q, k, v, 0)
    torch.cuda.synchronize()
    err = (got - plain_in_slices(q, k, v)).abs().max().item()
    fwd_err[1.0] = max(fwd_err[1.0], err)
    check(err <= ATTN_TOL, f"fused_mha export chunk: max abs err {err} > {ATTN_TOL}")
    chunk_ms = cuda_ms(lambda: fused_mha(q, k, v, 0), 5)
    chunk_plain_ms = cuda_ms(lambda: plain_in_slices(q, k, v), 2)
    chunk_sdpa_ms, sdpa_out = sdpa_ms(q, k, v)
    sdpa_err = (sdpa_out - got).abs().max().item()
    chunk_bound = attn_bound((chunk, 4, 1034, 1034, 4))
    say("kernel", f"export chunk ({chunk}, 4, 1034, 1034, 4) keep 1.0: max_abs_err {err:.3e}, "
        f"kernel {chunk_ms:.3f} ms, plain in 64-row slices {chunk_plain_ms:.3f} ms, "
        f"scaled_dot_product_attention {chunk_sdpa_ms:.3f} ms (max abs diff "
        f"from the kernel {sdpa_err:.3e}), bound {chunk_bound[0]:.3f} ms ({chunk_bound[1]})")
    del q, k, v, got, sdpa_out

    # the training batch: forward and backward, keep 0.5
    q, k, v = (t.requires_grad_() for t in qkv(TRAIN_BATCH, 4, 1034, 1034, 4))
    dout = torch.randn(q.shape, generator=gen, device=device)
    with torch.no_grad():
        err = (fused_mha(q, k, v, seed_t, 0.5) - plain_in_slices(q, k, v, seed_t, 0.5)).abs().max().item()
    fwd_err[0.5] = max(fwd_err[0.5], err)
    check(err <= ATTN_TOL, f"fused_mha training batch: max abs err {err} > {ATTN_TOL}")
    with torch.no_grad():
        train_fwd_ms = cuda_ms(lambda: fused_mha(q, k, v, seed_t, 0.5), 5)
        train_fwd_plain_ms = cuda_ms(lambda: plain_in_slices(q, k, v, seed_t, 0.5), 2)
    out = fused_mha(q, k, v, seed_t, 0.5)
    grads = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "fused_mha_bwd gave other bits on a second run at the training batch")
    del again
    scratch_mb = q.shape[0] * q.shape[1] * q.shape[2] * math.ceil(k.shape[2] / 32) * 4 / 1e6
    say("kernel", f"training batch backward: the same bits on a second run; keep-bit scratch "
        f"{scratch_mb:.1f} MB (int32 words, (B h, Lq, ceil(Lk / 32)))")
    train_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True), 5)
    train_bwd_plain_ms, errs, scale = plain_bwd_in_slices(q, k, v, dout, seed_t, 0.5, grads)
    rel = [e / m for e, m in zip(errs, scale)]
    bwd_err = max(bwd_err, *errs)
    say("kernel", f"training batch ({TRAIN_BATCH}, 4, 1034, 1034, 4) keep 0.5: fwd max_abs_err "
        f"{err:.3e}; bwd dq, dk, dv max abs err / max |plain| {rel[0]:.2e}, {rel[1]:.2e}, "
        f"{rel[2]:.2e} (bound {BWD_REL_TOL:g}); fwd kernel {train_fwd_ms:.3f} ms, plain in "
        f"64-row slices {train_fwd_plain_ms:.3f} ms; bwd kernel {train_bwd_ms:.3f} ms, plain "
        f"autograd in 32-row slices {train_bwd_plain_ms:.3f} ms")
    check(max(rel) <= BWD_REL_TOL, "fused_mha_bwd disagrees at the training batch")
    del q, k, v, dout, out, grads
    torch.cuda.empty_cache()
    train_shape = (TRAIN_BATCH, 4, 1034, 1034, 4)
    train_fwd_bound, train_bwd_bound = attn_bound(train_shape), attn_bound(train_shape, True)
    say("kernel", f"training batch bounds: fwd {train_fwd_bound[0]:.3f} ms "
        f"({train_fwd_bound[1]}), bwd {train_bwd_bound[0]:.3f} ms ({train_bwd_bound[1]})")

    # the row-sparse Adam and the streaming logsumexp: held to their plain
    # paths, then timed
    row_adam = row_adam_phase(gen, device)
    lse = lse_phase(gen, device)

    # 4. slice: export over every user ----------------------------------
    t0 = time.perf_counter()
    ds = (data_load(DATASET, args.data_root) if args.data_root
          else synthetic_dataset(DATASET, args.seed))
    cfg = Config(data_path=DATASET, seed=args.seed, **MODEL_CONFIG)
    model = build_model(cfg, ds, device)
    params = model.init_params(torch.Generator(device=device).manual_seed(args.seed))
    state = model.init_state(device)
    torch.cuda.synchronize()
    say("slice", f"{'data_load' if args.data_root else 'synthetic'} {DATASET} "
        f"({ds.num_user}, {ds.num_item}), {ds.num_edges} train edges; model built "
        f"in {time.perf_counter() - t0:.2f} s; {model.seq_len} tokens, "
        f"d_model {model.d_model}, {model.num_heads} heads, {model.cam_layers} rounds, "
        f"{model.steps} steps")
    n_chunks = math.ceil(ds.num_user / cfg.eval_user_chunk)
    export_launches = n_chunks * model.steps * model.cam_layers

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cf_diff.npz")
        torch.cuda.reset_peak_memory_stats()
        fused_mha.launches = fused_mha_bwd.launches = 0
        t0 = time.perf_counter()
        export_artifact(model, params, state, ds, path, eval_user_chunk=cfg.eval_user_chunk,
                        snapshot="final-epoch")
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        export_counts = (fused_mha.launches, fused_mha_bwd.launches)
        say("slice", f"export {ds.num_user} users: {export_s:.3f} s wall, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"fused_mha launches {export_counts[0]} (expected {n_chunks} chunks x "
            f"{model.steps} steps x {model.cam_layers} rounds = {export_launches}), "
            f"fused_mha_bwd launches {export_counts[1]} (expected 0)")
        check(export_counts == (export_launches, 0) and export_launches > 0,
              f"export launched {export_counts}, expected ({export_launches}, 0)")
        rank_ids, hist_global = check_artifact(path, ds, "final-epoch")
        say("slice", f"artifact: rank_ids {rank_ids.shape}, finite, descending, no seen item")

        ids = torch.arange(64)
        kernel_scores = model.score_users(params, ids)
        with plain_attention():
            plain_scores = model.score_users(params, ids)
        diff = (kernel_scores - plain_scores).abs().max().item()
        overlap = top_overlap(kernel_scores, plain_scores, 50)
        say("slice", f"64 users, kernel path vs plain path on the card: max abs diff "
            f"{diff:.3e} (bound {SCORE_TOL:g}), top-50 agreement {overlap:.4f} "
            f"(bound {TOPK_AGREE_MIN})")
        check(diff <= SCORE_TOL and overlap >= TOPK_AGREE_MIN, "kernel path disagrees with plain path")

        cpu_model = CF_Diff(model.num_user, model.num_item, model.x.cpu(), cfg.noise_scale,
                            cfg.noise_min, cfg.noise_max, cfg.steps)
        cpu_params = {n: t.cpu() for n, t in params.items()}
        cpu_scores = cpu_model.score_users(cpu_params, ids[:4])
        diff_cpu = (kernel_scores[:4].cpu() - cpu_scores).abs().max().item()
        say("slice", f"4 users, card vs CPU plain path: max abs diff {diff_cpu:.3e} "
            f"(bound {SCORE_TOL:g})")
        check(diff_cpu <= SCORE_TOL, "card disagrees with the CPU path")
        del cpu_model, cpu_params

        # 5. serve ------------------------------------------------------
        check_serving("serve", path, ds, device, rank_ids, hist_global)

        # The usual serving configuration, an embeddings artifact (random
        # dim-64 tables at this dataset's size): the card against the CPU.
        tables = [torch.randn((n, 64), generator=gen, device=device)
                  for n in (ds.num_user, ds.num_item)]
        emb_path = os.path.join(tmp, "tables.npz")
        export_artifact(RandomTables(), tables, None, ds, emb_path)
        on_card, on_cpu = Recommender.load(emb_path, device), Recommender.load(emb_path, "cpu")
        users = list(range(0, ds.num_user, 48))
        for name, query in (("recommend", lambda r: r.recommend(users, k=10)),
                            ("similar_items", lambda r: r.similar_items(users[:64], k=10)),
                            ("fold_in", lambda r: [r.fold_in([3, 17, 400], k=10)])):
            a, b = query(on_card), query(on_cpu)
            score_err = max(abs(x[1] - y[1]) for ra, rb in zip(a, b) for x, y in zip(ra, rb))
            same = np.mean([len({i for i, _ in ra} & {i for i, _ in rb}) / 10
                            for ra, rb in zip(a, b)])
            say("serve", f"embeddings {name}, {len(a)} queries, card vs CPU: max score "
                f"diff {score_err:.3e} (bound {SCORE_TOL:g}), top-10 agreement {same:.4f}")
            check(score_err <= SCORE_TOL and same >= TOPK_AGREE_MIN, f"embeddings {name} disagrees")
        lat = []
        for _ in range(50):
            t0 = time.perf_counter()
            on_card.recommend([0, 5, 17], k=10)
            lat.append((time.perf_counter() - t0) * 1e3)
        say("serve", f"embeddings recommend 3 users k=10 on the card, in process: "
            f"p50 {np.median(lat):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms")
        del tables, on_card, on_cpu

        # 6. profile: where one export chunk's device time goes ------------
        chunk_ids = torch.arange(cfg.eval_user_chunk)
        device_profile("profile", f"one export chunk of {cfg.eval_user_chunk} users "
                       f"(score_users, {model.steps} steps)",
                       lambda: model.score_users(params, chunk_ids),
                       os.path.join(args.out_dir, "chip_smoke_profile.txt"))
        del params, state
        torch.cuda.empty_cache()

        # 7. train: the CLI's grid run, 2 epochs, export of the best epoch --
        trained = os.path.join(tmp, "cf_diff_trained.npz")
        train_cfg = Config(data_path=DATASET, seed=args.seed, num_epoch=TRAIN_EPOCHS,
                           batch_size=TRAIN_BATCH, log_dir=args.out_dir,
                           export_artifact=trained, **MODEL_CONFIG)
        grid = {key: [MODEL_CONFIG[key]] for key in MODEL_CONFIG if key != "Model"}
        grid["hyper_parameters"] = list(grid)
        probe = EpochProbe()
        logging.getLogger().addFilter(probe)
        torch.cuda.reset_peak_memory_stats()
        fused_mha.launches = fused_mha_bwd.launches = 0
        t0 = time.perf_counter()
        try:
            best = cli.run(train_cfg, grid, ds, device)
            torch.cuda.synchronize()
        finally:
            logging.getLogger().removeFilter(probe)
        train_run_s = time.perf_counter() - t0
        train_launches = (fused_mha.launches, fused_mha_bwd.launches)
        n_batches = math.ceil(ds.num_user / TRAIN_BATCH)
        rounds = model.cam_layers
        expected = (TRAIN_EPOCHS * (n_batches * rounds + export_launches) + export_launches,
                    TRAIN_EPOCHS * n_batches * rounds)
        for e, ep in enumerate(probe.epochs):
            say("train", f"epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
                f"(training {ep['train_s']:.3f} s, eval {ep['eval_s']:.3f} s), peak device "
                f"memory {ep['peak_gib']:.2f} GiB")
        say("train", f"cli.run {TRAIN_EPOCHS} epochs x {n_batches} batches of {TRAIN_BATCH} "
            f"+ export: {train_run_s:.3f} s wall; launches fused_mha {train_launches[0]}, "
            f"fused_mha_bwd {train_launches[1]} (expected {expected[0]} = {TRAIN_EPOCHS} x "
            f"({n_batches} batches x {rounds} rounds + {export_launches} eval) + "
            f"{export_launches} export, and {expected[1]} = {TRAIN_EPOCHS} x {n_batches} x "
            f"{rounds})")
        check(train_launches == expected, f"training launched {train_launches}, expected {expected}")
        check(len(probe.epochs) == TRAIN_EPOCHS, f"{len(probe.epochs)} epochs logged")
        check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
        check(sorted(best) == [5, 10, 20] and all(
            math.isfinite(v) for m in best.values() for v in m.values()), f"best metrics {best}")
        say("train", "best test metrics: " + "; ".join(
            f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in best.items()))
        rank_ids, hist_global = check_artifact(trained, ds, "best-epoch")
        say("train", f"exported best epoch: rank_ids {rank_ids.shape}, finite, descending, "
            "no seen item")
        check_serving("train", trained, ds, device, rank_ids, hist_global)
    torch.cuda.empty_cache()

    # 8. step parity: kernel path against plain path, equal masks -----------
    params = model.init_params(torch.Generator(device=device).manual_seed(args.seed + 1))
    batch = Batch(torch.arange(8, device=device), torch.ones(8, device=device))

    def one_step():
        leaves = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
        loss, _ = model.loss_stateful(leaves, model.init_state(device), batch,
                                      torch.Generator(device=device).manual_seed(args.seed))
        loss.backward()
        return loss.item(), {n: t.grad for n, t in leaves.items()}

    before = (fused_mha.launches, fused_mha_bwd.launches)
    kernel_loss, kernel_grads = one_step()
    check((fused_mha.launches, fused_mha_bwd.launches) == (before[0] + rounds, before[1] + rounds),
          "the kernel step did not launch both kernels once per round")
    with plain_attention():
        plain_loss, plain_grads = one_step()
    scale = max(g.abs().max().item() for g in plain_grads.values())
    worst = max(((kernel_grads[n] - g).abs().max().item()
                 / (STEP_RTOL * g.abs().max().item() + STEP_ATOL * scale), n)
                for n, g in plain_grads.items())
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    say("step", f"8 users, one training step, kernel vs plain path with equal masks: loss "
        f"{kernel_loss:.6f} vs {plain_loss:.6f} (rel {loss_rel:.2e}, bound {STEP_LOSS_RTOL:g}); "
        f"worst gradient {worst[1]} at {worst[0]:.3f} of its bound (rtol {STEP_RTOL:g} of "
        f"the tensor's max + {STEP_ATOL:g} of the gradient's max {scale:.3e})")
    check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0, "training step disagrees")

    # 9. profile: where one training step's device time goes ---------------
    leaves = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
    opt = torch.optim.Adam(leaves.values(), lr=MODEL_CONFIG["learning_rate"])
    step_gen = torch.Generator(device=device).manual_seed(args.seed)
    full = Batch(torch.randperm(ds.num_user, device=device, generator=step_gen)[:TRAIN_BATCH],
                 torch.ones(TRAIN_BATCH, device=device))
    step_state = model.init_state(device)

    @deterministic_mode()  # as the trainer steps
    def train_step():
        opt.zero_grad(set_to_none=True)
        loss, _ = model.loss_stateful(leaves, step_state, full, step_gen)
        loss.backward()
        opt.step()

    device_profile("profile", f"one training step of {TRAIN_BATCH} users (forward, backward, "
                   "Adam)", train_step, os.path.join(args.out_dir, "chip_smoke_train_profile.txt"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_step()
    torch.cuda.synchronize()
    say("profile", f"one training step of {TRAIN_BATCH} users: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    del leaves, opt, params, full, step_state, model
    torch.cuda.empty_cache()

    fds = sports_dataset(args)
    freedom_launches, bf16_launches = freedom_phases(args, device, fds)
    ssl_launches = ssl_phases(args, device, fds)
    k4 = scan_phase(gen, device, fds)
    seg_launches = seg_phases(args, device, fds)
    t0 = time.perf_counter()
    bds = linear_dataset(args)
    linear_s = time.perf_counter() - t0 + linear_gcn_phases(args, device, bds)
    t0 = time.perf_counter()
    # phases 70-72's CLI children run beside phases 34-69 (collected at 70),
    # phases 73-78's child beside phases 34-72 (collected after 72)
    mesh_children = MeshRuns(args, fds)
    catalog_child = CatalogChild(args)
    det = determinism_phase(args, device, {DATASET: ds, FREEDOM_DATASET: fds,
                                           LINEAR_DATASET: bds})
    say("determinism", f"{len(DET_MODELS)} models twice on one seed: equal loss bits and rank "
        f"lists; {time.perf_counter() - t0:.1f} s added to the run")
    family = ("LightGCN",) + LINEAR_MODELS
    family_det_s = sum(sum(det[n]["seconds"]) for n in family)
    say("determinism", f"the linear-GCN family's share of the run: phases 30-33 and their data "
        f"{linear_s:.1f} s, their {len(family)} models' determinism runs {family_det_s:.1f} s; "
        f"{linear_s + family_det_s:.1f} s in all")
    idonly_s = idonly_phases(args, device, bds)
    idonly_det_s = sum(sum(det[n]["seconds"]) for n in IDONLY_MODELS)
    say("idprofile", f"the id-only models' share of the run: phases 35-38 {idonly_s:.1f} s, "
        f"their {len(IDONLY_MODELS)} models' determinism runs {idonly_det_s:.1f} s; "
        f"{idonly_s + idonly_det_s:.1f} s in all")
    family_s, gformer_launches, gformer_lse = family_phases(args, device, bds)
    family_det_s = sum(sum(det[n]["seconds"]) for n in FAMILY_TRAINED)
    say("famprofile", f"phases 39-42's share of the run: {family_s:.1f} s, their "
        f"{len(FAMILY_TRAINED)} trained models' determinism runs {family_det_s:.1f} s; "
        f"{family_s + family_det_s:.1f} s in all")
    family2_s, family2_k4, k4ag = family2_phases(args, device, bds)
    family2_det_s = sum(sum(det[n]["seconds"]) for n in FAMILY2_MODELS + TOWER_MODELS)
    say("fam2profile", f"phases 43-47's share of the run: {family2_s:.1f} s, their "
        f"{len(FAMILY2_MODELS + TOWER_MODELS)} models' determinism runs {family2_det_s:.1f} s; "
        f"{family2_s + family2_det_s:.1f} s in all")
    # phase 68's supervisor and its CLI child run beside phases 48-67
    # (collected at 68), once phases 70-72's children have had their time
    elastic = ElasticRun(args, fds)
    towers2_s = towers2_phases(args, device, bds)
    towers2_det_s = sum(sum(det[n]["seconds"]) for n in TOWER2_MODELS)
    say("tw2profile", f"phases 48-50's share of the run: {towers2_s:.1f} s, their "
        f"{len(TOWER2_MODELS)} models' determinism runs {towers2_det_s:.1f} s; "
        f"{towers2_s + towers2_det_s:.1f} s in all")
    towers3_s = towers3_phases(args, device, bds)
    towers3_det_s = sum(sum(det[n]["seconds"]) for n in TOWER3_MODELS)
    say("tw3profile", f"phases 51-53's share of the run: {towers3_s:.1f} s, their "
        f"{len(TOWER3_MODELS)} models' determinism runs {towers3_det_s:.1f} s; "
        f"{towers3_s + towers3_det_s:.1f} s in all")
    towers4_s = towers4_phases(args, device, bds)
    towers4_det_s = sum(sum(det[n]["seconds"]) for n in TOWER4_MODELS)
    say("tw4step", f"phases 54-57's share of the run: {towers4_s:.1f} s, their "
        f"{len(TOWER4_MODELS)} models' determinism runs {towers4_det_s:.1f} s; "
        f"{towers4_s + towers4_det_s:.1f} s in all")
    rebuild_s, micro_launches, k2micro = rebuild_phases(args, device, bds)
    rebuild_det_s = sum(sum(det[n]["seconds"]) for n in REBUILD_MODELS + (MMSSL_MODEL,))
    say("rgstep", f"phases 58-61's share of the run: {rebuild_s:.1f} s, their "
        f"{len(REBUILD_MODELS) + 1} models' determinism runs {rebuild_det_s:.1f} s; "
        f"{rebuild_s + rebuild_det_s:.1f} s in all")
    diffusion_s, diffusion_launches, k2diff, k4mh = diffusion_phases(args, device, bds)
    diffusion_det_s = sum(sum(det[n]["seconds"]) for n in DIFFUSION_MODELS)
    say("dfstep", f"phases 62-66's share of the run: {diffusion_s:.1f} s, their "
        f"{len(DIFFUSION_MODELS)} models' determinism runs {diffusion_det_s:.1f} s; "
        f"{diffusion_s + diffusion_det_s:.1f} s in all")
    resume_s, resume_launches, trace = resume_phases(
        args, device, {DATASET: ds, FREEDOM_DATASET: fds}, elastic)
    say("trace", f"phases 67-69's share of the run: {resume_s:.1f} s")
    mesh_s, k1_mesh, k2_mesh, mesh_launches = mesh_phases(args, device, fds, mesh_children)
    mesh_children.stop()
    say("mesh", f"phases 70-72's share of the run: {mesh_s:.1f} s")
    catalog_s, sgl_micro_k2, k2_micro, k2_elec, catalog_result = catalog_phases(args, device,
                                                                               catalog_child)
    say("catalog", f"phases 73-79's share of the run: {catalog_s:.1f} s")
    t_csr = time.perf_counter()
    csr_times = csr_spmm_phases(args, device)
    say("csr", f"phase 80's share of the run: {time.perf_counter() - t_csr:.1f} s")
    say("result", f"the whole run to here: {time.perf_counter() - t_run:.1f} s")

    # result -----------------------------------------------------------
    # One entry per path and shape; each path's launches are its own run's
    # (the CF_Diff export of phase 4, the CLI runs of phases 7, 10, 14, 21,
    # 24, 27, 39, 43, 58, 62, 63 and 74, the bf16 epoch of phase 13).
    fwd = dict(route="cuda", source="chaorec_tpu_torch/csrc/fused_mha.cu",
               replaces="chaorec_tpu/ops/pallas_attn.py:65")
    no_library = "no PyTorch call draws this Philox dropout mask"
    entries = [
        {"name": "fused_mha@export", **fwd, "shape": [chunk, 4, 1034, 1034, 4],
         "keep_prob": 1.0, "launches": export_counts[0], "max_abs_err": fwd_err[1.0],
         "ms": chunk_ms, "plain_ms": chunk_plain_ms, "bound_ms": chunk_bound[0],
         "bound_by": chunk_bound[1], "library_ms": chunk_sdpa_ms,
         "note": "library: scaled_dot_product_attention, one call"},
        {"name": "fused_mha@train", **fwd, "shape": list(train_shape),
         "keep_prob": 0.5, "launches": train_launches[0], "max_abs_err": fwd_err[0.5],
         "ms": train_fwd_ms, "plain_ms": train_fwd_plain_ms, "bound_ms": train_fwd_bound[0],
         "bound_by": train_fwd_bound[1], "library_ms": None,
         "note": "launches: the CLI run's training forwards at keep 0.5 and its eval "
                 f"and export forwards at keep 1.0; {no_library}"},
        {"name": "fused_mha_bwd@train", "route": "cuda",
         "source": "chaorec_tpu_torch/csrc/fused_mha_bwd.cu",
         "replaces": "chaorec_tpu/ops/pallas_attn.py:82",
         "shape": list(train_shape), "keep_prob": 0.5,
         "launches": train_launches[1], "max_abs_err": bwd_err, "ms": train_bwd_ms,
         "plain_ms": train_bwd_plain_ms, "bound_ms": train_bwd_bound[0],
         "bound_by": train_bwd_bound[1], "library_ms": None,
         "note": "one launch is one backward call: the dq kernel (which draws each keep bit "
                 f"once into a scratch), then the dk/dv kernel (which reads it); {no_library}"},
    ]
    for dtype, launches, run in (("float32", freedom_launches, "the FREEDOM CLI run's"),
                                 ("bfloat16", bf16_launches, "the bf16 epoch's")):
        for name, shape in ROW_ADAM_SHAPES:
            entries.append({
                "name": f"fused_row_adam@train[{name}{'' if dtype == 'float32' else ',bf16'}]",
                "route": "cuda", "source": "chaorec_tpu_torch/csrc/row_adam.cu",
                "replaces": "chaorec_tpu/ops/pallas_row_adam.py:44", "shape": list(shape),
                "dtype": dtype, "launches": launches, **row_adam[name, dtype],
                "note": f"launches: {run} count over both tables (one launch per table per "
                        "step); library: zeros + index_add_ + Adam(fused=True).step"})
    nl = ssl_launches["NCL"]
    for side, (b, n, e, temp, _) in LSE_TIMED.items():
        model = "ncl" if side == "prototypes" else "sgl"
        for i, (kernel, line) in enumerate((("fwd", 44), ("dq", 95), ("dk", 116))):
            if kernel not in lse[side]:
                continue
            entries.append({
                "name": f"streaming_lse_{kernel}@{model}[{side}]", "route": "cuda",
                "source": "chaorec_tpu_torch/csrc/streaming_lse.cu",
                "replaces": f"chaorec_tpu/ops/pallas_lse.py:{line}", "shape": [b, n, e],
                "temperature": temp,
                "launches": (nl if model == "ncl" else ssl_launches["SGL"])[i],
                "max_abs_err": lse["max_abs_err"][kernel], **lse[side][kernel],
                "note": (f"launches: the {model.upper()} CLI run's, all its terms"
                         + ("" if model == "ncl" else f" (the NCL run's: {nl[i]})")
                         + "; one launch is the kernel and its combine pass; library: no single "
                         "PyTorch call computes this: torch.mm and torch.logsumexp"
                         f"{'' if kernel == 'fwd' else ' and their autograd'}, timed together")})
    for side, (b, n) in (("user", (1024, bds.num_user)), ("item", (1024, bds.num_item)),
                         ("cross", (1024, bds.num_item))):
        for i, (kernel, line) in enumerate((("fwd", 44), ("dq", 95), ("dk", 116))):
            entries.append({
                "name": f"streaming_lse_{kernel}@gformer[{side}]", "route": "cuda",
                "source": "chaorec_tpu_torch/csrc/streaming_lse.cu",
                "replaces": f"chaorec_tpu/ops/pallas_lse.py:{line}", "shape": [b, n, 64],
                "temperature": 1.0, "launches": gformer_launches[i],
                "max_abs_err": gformer_lse["max_abs_err"][kernel], **gformer_lse[side][kernel],
                "note": "launches: the GFormer CLI run's, all its three terms; user and item: "
                        "q rows of k's own table (dq and dk reach one table), cross: user rows "
                        "against the item table; library: torch.mm and torch.logsumexp"
                        f"{'' if kernel == 'fwd' else ' and their autograd'}, timed together"})
    seg_names = {"dgcf": "DGCF", "dccf": "DCCF", "mgat_v": "MGAT", "mgat_t": "MGAT",
                 "mgat": "MGAT"}
    for name, (m, d) in scan_shapes(fds).items():
        model = seg_names[name]
        entries.append({
            "name": f"prefix_scan@{name}", "route": "cuda",
            "source": "chaorec_tpu_torch/csrc/prefix_scan.cu",
            "replaces": "chaorec_tpu/ops/pallas_scan.py:49", "shape": [m, d],
            "launches": seg_launches[model], **k4[name],
            "note": f"launches: the {model} CLI run's, over all its shapes (one launch is a "
                    "memset of its scratch and the one-pass kernel); ms: 20 calls back to back; "
                    "graph_ms: 20 calls in one CUDA graph; library: torch.cumsum, one call"})
    for name in FAMILY2_MODELS:
        cfg, _ = path_config(name, args)
        entries.append({
            "name": f"prefix_scan@{name.lower()}", "route": "cuda",
            "source": "chaorec_tpu_torch/csrc/prefix_scan.cu",
            "replaces": "chaorec_tpu/ops/pallas_scan.py:49", **k4ag,
            "launches": family2_k4[name],
            "note": f"launches: the {name} CLI run's ({FAMILY2_EPOCHS} epochs, "
                    f"{scan_launches(cfg)[0]} a step and {scan_launches(cfg)[1]} an evaluation, "
                    "all at this shape: the doubled edges by dim_E); AdaGCL's and Grade's "
                    "entries share one measurement of the shape; ms: 20 calls back to back; "
                    "graph_ms: 20 calls in one CUDA graph; library: torch.cumsum, one call"})
    micro_n = bds.num_item
    micro_tau = first_combo("MICRO")[0]["ssl_temp"]
    for i, (kernel, line) in enumerate((("fwd", 44), ("dq", 95), ("dk", 116))):
        entries.append({
            "name": f"streaming_lse_{kernel}@micro", "route": "cuda",
            "source": "chaorec_tpu_torch/csrc/streaming_lse.cu",
            "replaces": f"chaorec_tpu/ops/pallas_lse.py:{line}",
            "shape": [micro_n, 2 * micro_n, 64],
            "temperature": micro_tau, "launches": micro_launches[i],
            "max_abs_err": k2micro["max_abs_err"][kernel], **k2micro["micro"][kernel],
            "note": f"launches: the MICRO CLI run's ({REBUILD_EPOCHS} epoch, {MICRO_TERMS} terms a "
                    "step: each modal view's unit rows over the temperature against them and the "
                    "fused view's, so dq and dk reach one table); library: torch.mm and "
                    f"torch.logsumexp{'' if kernel == 'fwd' else ' and their autograd'}, timed "
                    "together"})
    diff_tau = first_combo("DiffMM")[0]["ssl_temp"]
    for model in DIFFUSION_MODELS:
        for side, n in (("user", bds.num_user), ("item", bds.num_item)):
            for i, (kernel, line) in enumerate((("fwd", 44), ("dq", 95), ("dk", 116))):
                entries.append({
                    "name": f"streaming_lse_{kernel}@{model.lower()}[{side}]", "route": "cuda",
                    "source": "chaorec_tpu_torch/csrc/streaming_lse.cu",
                    "replaces": f"chaorec_tpu/ops/pallas_lse.py:{line}", "shape": [1024, n, 64],
                    "temperature": diff_tau, "launches": diffusion_launches[model][i],
                    "max_abs_err": k2diff["max_abs_err"][kernel], **k2diff[side][kernel],
                    "note": f"launches: the {model} CLI run's ({DIFFUSION_EPOCHS} epoch, "
                            f"{DIFFUSION_TERMS[model]} terms a phase-C step, half of them at "
                            "each shape); q: 1024 gathered unit rows of one tower over the "
                            "temperature, k: the unit rows of another; DiffMM's and MHRec's "
                            "entries share one measurement of each shape; library: torch.mm "
                            f"and torch.logsumexp{'' if kernel == 'fwd' else ' and their autograd'}"
                            ", timed together"})
    for key, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        entries.append({
            "name": f"prefix_scan@mhrec[{key}]", "route": "cuda",
            "source": "chaorec_tpu_torch/csrc/prefix_scan.cu",
            "replaces": "chaorec_tpu/ops/pallas_scan.py:49", "shape": list(k4mh["shape"]),
            "dtype": dtype, "launches": diffusion_launches["MHRec"][4].get(dtype, 0),
            "max_abs_err": k4mh["max_abs_err"][key], **k4mh[key],
            "note": "launches: the MHRec CLI run's with this input dtype (seg_edge_weighted_sum's "
                    "forward takes fp32 messages, seg_gather's backward the slot rows' bf16 "
                    "cotangent; the run's total is the sum of the two); ms: 20 calls back to "
                    "back; graph_ms: 20 calls in one CUDA graph; library: torch.cumsum to "
                    "float32, one call"})
    # the resume path (phase 67): each kernel's launches in the resumed run,
    # beside the measurement of its shape above
    resumed_note = ("launches: the {} run resumed from its epoch-{} checkpoint (one epoch); "
                    "the times are the entry {}'s, the same shape")
    for name, shape in ROW_ADAM_SHAPES:
        entries.append({
            "name": f"fused_row_adam@resume[{name}]", "route": "cuda",
            "source": "chaorec_tpu_torch/csrc/row_adam.cu",
            "replaces": "chaorec_tpu/ops/pallas_row_adam.py:44", "shape": list(shape),
            "dtype": "float32", "launches": resume_launches["FREEDOM"]["fused_row_adam"],
            **row_adam[name, "float32"],
            "note": resumed_note.format("FREEDOM", RESUME_SPLIT, f"fused_row_adam@train[{name}]")
                    + " (both tables' launches)"})
    by_name = {e["name"]: e for e in entries}
    entries.append({**by_name["fused_mha@train"], "name": "fused_mha@resume",
                    "launches": resume_launches["CF_Diff"]["fused_mha"],
                    "note": resumed_note.format("CF_Diff", RESUME_SPLIT, "fused_mha@train")
                    + f" (its training and evaluation forwards); {no_library}"})
    entries.append({**by_name["fused_mha_bwd@train"], "name": "fused_mha_bwd@resume",
                    "launches": resume_launches["CF_Diff"]["fused_mha_bwd"],
                    "note": resumed_note.format("CF_Diff", RESUME_SPLIT, "fused_mha_bwd@train")
                    + f"; {no_library}"})
    entries.append({**by_name["prefix_scan@dgcf"], "name": "prefix_scan@resume[dgcf]",
                    "launches": resume_launches["DGCF"]["prefix_cumsum"],
                    "note": resumed_note.format("DGCF", RESUME_SPLIT, "prefix_scan@dgcf")
                    + "; library: torch.cumsum, one call"})
    # the mesh (phases 71-72): launches summed over the run's ranks
    k1_ranks = mesh_launches[MESH_RUNS[1][1]]
    for name, shape in MESH_ROW_ADAM:
        entries.append({
            "name": f"fused_row_adam@mesh[{name}]", "route": "cuda",
            "source": "chaorec_tpu_torch/csrc/row_adam.cu",
            "replaces": "chaorec_tpu/ops/pallas_row_adam.py:44", "shape": list(shape),
            "dtype": "float32",
            "launches": sum(r["fused_row_adam"] for r in k1_ranks.values()),
            **k1_mesh[name],
            "note": f"launches: the FREEDOM --mesh_shape {MESH_RUNS[1][1]} CLI run's, its "
                    f"{len(k1_ranks)} ranks' summed (each rank steps its shard of both tables "
                    "every step); library: zeros + index_add_ + Adam(fused=True).step"})
    k2_ranks = mesh_launches[MESH_RUNS[2][1]]
    for side, (b, n, e, temp, _) in MESH_LSE.items():
        for kernel, line in (("fwd", 44), ("dq", 95), ("dk", 116)):
            entries.append({
                "name": f"streaming_lse_{kernel}@mesh[{side}]", "route": "cuda",
                "source": "chaorec_tpu_torch/csrc/streaming_lse.cu",
                "replaces": f"chaorec_tpu/ops/pallas_lse.py:{line}", "shape": [b, n, e],
                "temperature": temp,
                "launches": sum(r[f"streaming_lse_{kernel}"] for r in k2_ranks.values()),
                "max_abs_err": k2_mesh["max_abs_err"][kernel], **k2_mesh[side][kernel],
                "note": f"launches: the SGL --mesh_shape {MESH_RUNS[2][1]} CLI run's, both "
                        "ranks' summed, both sides (q: a rank's half of the batch's rows); "
                        "library: torch.mm and torch.logsumexp"
                        f"{'' if kernel == 'fwd' else ' and their autograd'}, timed together"})
    # the large catalogs (phases 74 and 79): K2 at SGL's two microlens shapes,
    # launched by phase 74's run, and at electronics' two sides, held alone
    for cat, k2, launches, note in (
            (MICROLENS, k2_micro, sgl_micro_k2,
             "launches: phase 74's SGL CLI run at microlens, both sides (2 terms a step)"),
            (ELECTRONICS, k2_elec, (0, 0, 0),
             "launches: none on a CLI run of this script (phase 79 holds and times K2 at "
             "electronics' two sides alone; no run here trains a K2 model at electronics)")):
        for side, n in zip(("user", "item"), DATASET_STATS[cat]):
            for i, (kernel, line) in enumerate((("fwd", 44), ("dq", 95), ("dk", 116))):
                entries.append({
                    "name": f"streaming_lse_{kernel}@{cat}[{side}]", "route": "cuda",
                    "source": "chaorec_tpu_torch/csrc/streaming_lse.cu",
                    "replaces": f"chaorec_tpu/ops/pallas_lse.py:{line}", "shape": [1024, n, 64],
                    "temperature": SGL_TAU, "launches": launches[i],
                    "max_abs_err": k2["max_abs_err"][kernel], **k2[side][kernel],
                    "note": f"{note}; q: 1024 unit rows over the temperature, k: n unit rows; "
                            "library: torch.mm and torch.logsumexp"
                            f"{'' if kernel == 'fwd' else ' and their autograd'}, timed together"})
    # the segment graph's CSR gather-sum (phase 80), which replaces no TPU
    # kernel: the library yardstick is the parent path it replaced; its
    # launches as phases 73-77 counted them on the main path
    csr_phases = {MICROLENS: (73, 74), ELECTRONICS: (76, 77)}
    for cat, calls in csr_times.items():
        launched = "; ".join(
            f"{c['model']}'s CLI run {c['cli']} and its {c['steps']} profiled steps {c['step']} "
            f"(phase {number}: {2 * c['sums']} a step, {c['sums']} a ranking pass or export)"
            for number in csr_phases[cat] for c in [catalog_result["csr"][str(number)]])
        for call, t in calls.items():
            entries.append({
                "name": f"csr_spmm@{cat}[{call}]", "route": "cuda",
                "source": "chaorec_tpu_torch/csrc/csr_spmm.cu",
                "replaces": "none (the segment graph's gather and deterministic index_add_)",
                "launches": launched, **t,
                "note": "bits equal to the parent path's; bound: each gathered row once an "
                        "edge, the ids, weights and output, over 3.35 TB/s (the rows mostly "
                        "come from L2); chain: the hottest row's dependent adds; library: "
                        "the gather, product and index_add_ (index_put_ for bwd) under the "
                        "deterministic mode"})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
