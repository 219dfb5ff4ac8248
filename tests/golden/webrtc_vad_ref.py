"""Literal fixed-point transcription of WebRTC's voice-activity detector.

This is the golden for the per-frame VAD *decision*.  The reference pipeline's every
silent gate and VAD trim flows through ``webrtcvad.Vad(3)``
(`/root/reference/OverlapDetection/scripts/record_on_pc.py:33,229-295`),
which wraps WebRTC's published C sources:

    common_audio/vad/vad_core.c        (GMM likelihood-ratio test + update)
    common_audio/vad/vad_filterbank.c  (6-band split filterbank + log energy)
    common_audio/vad/vad_sp.c          (2:1 downsampler, minimum tracking)
    common_audio/vad/vad_gaussian.c    (fixed-point Gaussian probability)
    common_audio/signal_processing/*   (norm / division helpers)

This module transcribes that algorithm into pure Python integers with
explicit 16/32-bit wrap-around, exactly as ``tests/golden/vad_ref.py`` did
for the collector state machine.  It deliberately uses no numpy vector math
and nothing from ``mmla_audio_tpu`` — it is the independent yardstick the
package implementation (`mmla_audio_tpu/vad/webrtc.py`) must match
bit-for-bit.

The environment ships neither the `webrtcvad` wheel nor network access
(checked: ``ModuleNotFoundError``), so the published tables and arithmetic
below are the strongest available ground truth; every constant is WebRTC's
published value (Q-format noted inline).

Supported input: 8 kHz and 16 kHz, 10/20/30 ms frames (all the reference
uses is 16 kHz / 30 ms).  32/48 kHz need WebRTC's 48->8 kHz resampler chain,
which the reference never exercises; they raise ``ValueError``.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Fixed-width helpers (C semantics on Python ints)
# ---------------------------------------------------------------------------


def s16(x: int) -> int:
    """Wrap to int16_t."""
    x &= 0xFFFF
    return x - 0x10000 if x >= 0x8000 else x


def s32(x: int) -> int:
    """Wrap to int32_t."""
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def div_w32_w16(num: int, den: int) -> int:
    """WebRtcSpl_DivW32W16: C integer division (truncates toward zero)."""
    if den == 0:
        return 0x7FFFFFFF
    q = abs(num) // abs(den)
    return -q if (num < 0) != (den < 0) else q


def norm_w32(a: int) -> int:
    """WebRtcSpl_NormW32: left shifts to normalize an int32 (0 for 0)."""
    if a == 0:
        return 0
    if a < 0:
        a = ~a
        if a == 0:
            return 31
    return 31 - a.bit_length()


def norm_u32(a: int) -> int:
    """WebRtcSpl_NormU32: leading zeros of a uint32 (0 for 0)."""
    if a == 0:
        return 0
    return 32 - a.bit_length()


# ---------------------------------------------------------------------------
# Constants (all published WebRTC tables; Q-formats as annotated upstream)
# ---------------------------------------------------------------------------

NUM_CHANNELS = 6
NUM_GAUSSIANS = 2
TABLE_SIZE = NUM_CHANNELS * NUM_GAUSSIANS

# vad_core.c
SPECTRUM_WEIGHT = [6, 8, 10, 12, 14, 16]
NOISE_UPDATE_CONST = 655       # Q15
SPEECH_UPDATE_CONST = 6554     # Q15
BACK_ETA = 154                 # Q8
MINIMUM_DIFFERENCE = [544, 544, 576, 576, 576, 576]       # Q5
MAXIMUM_SPEECH = [11392, 11392, 11520, 11520, 11520, 11520]  # Q7
MAXIMUM_NOISE = [9216, 9088, 8960, 8832, 8704, 8576]      # Q7
# Start values for the Gaussian models (Q7)
NOISE_DATA_WEIGHTS = [34, 62, 72, 66, 53, 25, 94, 66, 56, 62, 75, 103]
SPEECH_DATA_WEIGHTS = [48, 82, 45, 87, 50, 47, 80, 46, 83, 41, 78, 81]
NOISE_DATA_MEANS = [6738, 4892, 7065, 6715, 6771, 3369,
                    7646, 3863, 7820, 7266, 5020, 4362]
SPEECH_DATA_MEANS = [8306, 10085, 10078, 11823, 11843, 6309,
                     9473, 9571, 10879, 7581, 8180, 7483]
NOISE_DATA_STDS = [378, 1064, 493, 582, 688, 593,
                   474, 697, 475, 688, 421, 455]
SPEECH_DATA_STDS = [555, 505, 567, 524, 585, 1231,
                    509, 828, 492, 1540, 1079, 850]
MAX_SPEECH_FRAMES = 6
MIN_STD = 384
MIN_ENERGY = 10

# Mode thresholds, indexed [10 ms, 20 ms, 30 ms] frames.
OVER_HANG_MAX_1 = {0: [8, 4, 3], 1: [8, 4, 3], 2: [6, 3, 2], 3: [6, 3, 2]}
OVER_HANG_MAX_2 = {0: [14, 7, 5], 1: [14, 7, 5], 2: [9, 5, 3], 3: [9, 5, 3]}
LOCAL_THRESHOLD = {0: [24, 21, 24], 1: [37, 32, 37],
                   2: [82, 78, 82], 3: [94, 94, 94]}
GLOBAL_THRESHOLD = {0: [57, 48, 57], 1: [100, 80, 100],
                    2: [285, 260, 285], 3: [1100, 1050, 1100]}

# vad_filterbank.c
LOG_CONST = 24660            # 160*log10(2) in Q9
LOG_ENERGY_INT_PART = 14336  # 14 in Q10
HP_ZERO_COEFS = [6631, -13262, 6631]     # Q14
HP_POLE_COEFS = [16384, -7756, 5620]     # Q14
ALL_PASS_COEFS_Q15 = [20972, 5571]       # 0.64, 0.17 (split filterbank)
OFFSET_VECTOR = [368, 368, 272, 176, 176, 176]

# vad_sp.c
ALL_PASS_COEFS_Q13 = [5243, 1392]        # 0.64, 0.17 (2:1 downsampler)
SMOOTHING_DOWN = 6553    # 0.2 in Q15
SMOOTHING_UP = 32439     # 0.99 in Q15

# vad_gaussian.c
COMP_VAR = 22005
LOG2_EXP = 5909          # log2(exp(1)) in Q12


# ---------------------------------------------------------------------------
# vad_gaussian.c — GaussianProbability
# ---------------------------------------------------------------------------


def gaussian_probability(inp: int, mean: int, std: int) -> tuple[int, int]:
    """(1/s)*exp(-(x-m)^2/(2 s^2)) in Q20, and delta=(x-m)/s^2 in Q11."""
    # inv_std = 1/s in Q10 (131072 = 1 in Q17; std>>1 rounds the division).
    tmp32 = s32(131072 + (std >> 1))
    inv_std = s16(div_w32_w16(tmp32, std))
    # inv_std2 = 1/s^2 in Q14.
    tmp16 = inv_std >> 2                      # Q8
    inv_std2 = s16(s32(tmp16 * tmp16) >> 2)   # Q14
    tmp16 = s16(inp << 3)                     # Q7
    tmp16 = s16(tmp16 - mean)                 # Q7
    # delta = (x-m)/s^2 in Q11: (Q14*Q7)>>10.
    delta = s16(s32(inv_std2 * tmp16) >> 10)
    # Exponent (x-m)^2/(2 s^2) in Q10: (Q11*Q7)>>9 (extra 1 = the /2).
    tmp32 = s32(delta * tmp16) >> 9
    exp_value = 0
    if tmp32 < COMP_VAR:
        # exp(-tmp32) ~= exp2(-log2(e)*tmp32), in Q10.
        tmp16 = s16(s32(LOG2_EXP * tmp32) >> 12)   # Q10
        tmp16 = s16(-tmp16)
        exp_value = 0x0400 | (tmp16 & 0x03FF)
        tmp16 = s16(~tmp16 & 0xFFFF)
        tmp16 >>= 10
        tmp16 = s16(tmp16 + 1)
        exp_value >>= tmp16
    return s32(inv_std * exp_value), delta     # Q20 (Q10*Q10)


# ---------------------------------------------------------------------------
# vad_sp.c — Downsampling and FindMinimum
# ---------------------------------------------------------------------------


def downsampling(signal_in: list[int], filter_state: list[int]) -> list[int]:
    """2:1 decimation via an allpass pair (Q13 coefs, int32 states)."""
    tmp32_1 = filter_state[0]
    tmp32_2 = filter_state[1]
    half_length = len(signal_in) >> 1
    out = [0] * half_length
    for n in range(half_length):
        x0 = signal_in[2 * n]
        x1 = signal_in[2 * n + 1]
        # All-pass filtering upper branch.
        tmp16_1 = s16((tmp32_1 >> 1)
                      + (s32(ALL_PASS_COEFS_Q13[0] * x0) >> 14))
        out[n] = tmp16_1
        tmp32_1 = s32(x0 - (s32(ALL_PASS_COEFS_Q13[0] * tmp16_1) >> 12))
        # All-pass filtering lower branch.
        tmp16_2 = s16((tmp32_2 >> 1)
                      + (s32(ALL_PASS_COEFS_Q13[1] * x1) >> 14))
        out[n] = s16(out[n] + tmp16_2)
        tmp32_2 = s32(x1 - (s32(ALL_PASS_COEFS_Q13[1] * tmp16_2) >> 12))
    filter_state[0] = tmp32_1
    filter_state[1] = tmp32_2
    return out


def find_minimum(self: "WebRtcVadRef", feature_value: int,
                 channel: int) -> int:
    """Track the 16 smallest feature values over the last 100 frames and
    return the smoothed median of the smallest (vad_sp.c)."""
    offset = channel << 4
    age = self.index_vector
    smallest = self.low_value_vector
    current_median = 1600
    alpha = 0

    # Each value gets one loop older; remove too-old values.
    i = 0
    while i < 16:
        if age[offset + i] != 100:
            age[offset + i] += 1
        else:
            for j in range(i, 15):
                smallest[offset + j] = smallest[offset + j + 1]
                age[offset + j] = age[offset + j + 1]
            age[offset + 15] = 101
            smallest[offset + 15] = 10000
        i += 1

    # Binary-search insert position (upstream's unrolled comparison tree is
    # equivalent to: first index whose value exceeds feature_value, if any).
    position = -1
    if feature_value < smallest[offset + 15]:
        position = 15
        while position > 0 and feature_value < smallest[offset + position - 1]:
            position -= 1
    if position > -1:
        for i in range(15, position, -1):
            smallest[offset + i] = smallest[offset + i - 1]
            age[offset + i] = age[offset + i - 1]
        smallest[offset + position] = feature_value
        age[offset + position] = 1

    if self.frame_counter > 2:
        current_median = smallest[offset + 2]
    elif self.frame_counter > 0:
        current_median = smallest[offset + 0]

    # Smooth the median value.
    if self.frame_counter > 0:
        if current_median < self.mean_value[channel]:
            alpha = SMOOTHING_DOWN
        else:
            alpha = SMOOTHING_UP
    tmp32 = s32((alpha + 1) * self.mean_value[channel])
    tmp32 = s32(tmp32 + (32767 - alpha) * current_median)
    tmp32 = s32(tmp32 + 16384)
    self.mean_value[channel] = s16(tmp32 >> 15)
    return self.mean_value[channel]


# ---------------------------------------------------------------------------
# vad_filterbank.c — AllPassFilter / SplitFilter / HighPassFilter / energies
# ---------------------------------------------------------------------------


def all_pass_filter(data_in: list[int], stride_offset: int, length: int,
                    coef: int, state: list[int], idx: int) -> list[int]:
    """In-band allpass over every 2nd sample; int16 state, Q15 internal."""
    state32 = s32(state[idx] * (1 << 16))        # Q15
    out = [0] * length
    for i in range(length):
        x = data_in[stride_offset + 2 * i]
        tmp32 = s32(state32 + coef * x)
        tmp16 = s16(tmp32 >> 16)                  # Q(-1)
        out[i] = tmp16
        state32 = s32(x * (1 << 14) - coef * tmp16)   # Q14
        state32 = s32(state32 * 2)                # Q15
    state[idx] = s16(state32 >> 16)
    return out


def split_filter(data_in: list[int], state_u: list[int], state_l: list[int],
                 band: int) -> tuple[list[int], list[int]]:
    """Half-band split + 2:1 decimation -> (high band, low band)."""
    half = len(data_in) >> 1
    hp = all_pass_filter(data_in, 0, half, ALL_PASS_COEFS_Q15[0],
                         state_u, band)
    lp = all_pass_filter(data_in, 1, half, ALL_PASS_COEFS_Q15[1],
                         state_l, band)
    for i in range(half):
        tmp = hp[i]
        hp[i] = s16(hp[i] - lp[i])
        lp[i] = s16(lp[i] + tmp)
    return hp, lp


def high_pass_filter(data_in: list[int], state: list[int]) -> list[int]:
    """80 Hz biquad high-pass (Q14 coefficients, DF1 with int16 states)."""
    out = [0] * len(data_in)
    for i, x in enumerate(data_in):
        tmp32 = s32(HP_ZERO_COEFS[0] * x)
        tmp32 = s32(tmp32 + HP_ZERO_COEFS[1] * state[0])
        tmp32 = s32(tmp32 + HP_ZERO_COEFS[2] * state[1])
        state[1] = state[0]
        state[0] = x
        tmp32 = s32(tmp32 - HP_POLE_COEFS[1] * state[2])
        tmp32 = s32(tmp32 - HP_POLE_COEFS[2] * state[3])
        state[3] = state[2]
        state[2] = s16(tmp32 >> 14)
        out[i] = state[2]
    return out


def get_scaling_square(vector: list[int]) -> int:
    """WebRtcSpl_GetScalingSquare with times == len(vector)."""
    nbits = len(vector).bit_length()
    smax = 0
    for v in vector:
        sabs = v if v > 0 else -v
        if sabs > smax:
            smax = sabs
    if smax == 0:
        return 0
    t = norm_w32(s32(smax * smax))
    return 0 if t > nbits else nbits - t


def energy(vector: list[int]) -> tuple[int, int]:
    """WebRtcSpl_Energy: (sum((v*v)>>scaling), scaling)."""
    scaling = get_scaling_square(vector)
    en = 0
    for v in vector:
        en = s32(en + (s32(v * v) >> scaling))
    return en, scaling


def log_of_energy(data_in: list[int], offset: int, total_energy: int
                  ) -> tuple[int, int]:
    """10*log10(energy) in Q4 (+offset); returns (log_energy, total_energy)."""
    en, tot_rshifts = energy(data_in)
    en &= 0xFFFFFFFF                       # uint32 view
    if en != 0:
        normalizing_rshifts = 17 - norm_u32(en)
        log2_energy = LOG_ENERGY_INT_PART
        tot_rshifts += normalizing_rshifts
        if normalizing_rshifts < 0:
            en = (en << -normalizing_rshifts) & 0xFFFFFFFF
        else:
            en >>= normalizing_rshifts
        log2_energy = s16(log2_energy + ((en & 0x00003FFF) >> 4))  # Q10
        log_energy = s16((s32(LOG_CONST * log2_energy) >> 19)
                         + (s32(tot_rshifts * LOG_CONST) >> 9))
        if log_energy < 0:
            log_energy = 0
        log_energy = s16(log_energy + offset)
        if total_energy <= MIN_ENERGY:
            if tot_rshifts >= 0:
                # energy > MIN_ENERGY in Q0 by construction.
                total_energy = s16(total_energy + MIN_ENERGY + 1)
            else:
                total_energy = s16(total_energy + s16(en >> -tot_rshifts))
        return log_energy, total_energy
    return offset, total_energy


def calculate_features(self: "WebRtcVadRef", data_in: list[int]
                       ) -> tuple[list[int], int]:
    """6-band log energies (Q4) + approximate total energy (vad_filterbank.c).

    ``data_in``: one 8 kHz frame (80/160/240 samples).
    """
    features = [0] * NUM_CHANNELS
    total_energy = 0

    # Split at 2000 Hz and downsample.
    hp_120, lp_120 = split_filter(data_in, self.upper_state,
                                  self.lower_state, 0)
    # Upper band: split at 3000 Hz.
    hp_60, lp_60 = split_filter(hp_120, self.upper_state, self.lower_state, 1)
    # Energy in 3000-4000 Hz / 2000-3000 Hz.
    features[5], total_energy = log_of_energy(hp_60, OFFSET_VECTOR[5],
                                              total_energy)
    features[4], total_energy = log_of_energy(lp_60, OFFSET_VECTOR[4],
                                              total_energy)
    # Lower band: split at 1000 Hz.
    hp_60, lp_60 = split_filter(lp_120, self.upper_state, self.lower_state, 2)
    features[3], total_energy = log_of_energy(hp_60, OFFSET_VECTOR[3],
                                              total_energy)
    # Split at 500 Hz.
    hp_30, lp_30 = split_filter(lp_60, self.upper_state, self.lower_state, 3)
    features[2], total_energy = log_of_energy(hp_30, OFFSET_VECTOR[2],
                                              total_energy)
    # Split at 250 Hz.
    hp_15, lp_15 = split_filter(lp_30, self.upper_state, self.lower_state, 4)
    features[1], total_energy = log_of_energy(hp_15, OFFSET_VECTOR[1],
                                              total_energy)
    # Remove 0-80 Hz from the lowest band.
    hp80 = high_pass_filter(lp_15, self.hp_filter_state)
    features[0], total_energy = log_of_energy(hp80, OFFSET_VECTOR[0],
                                              total_energy)
    return features, total_energy


# ---------------------------------------------------------------------------
# vad_core.c — GmmProbability
# ---------------------------------------------------------------------------


def weighted_average(data: list[int], channel: int, offset: int,
                     weights: list[int]) -> int:
    """Mutating weighted mean over the two Gaussians of one channel (Q14)."""
    result = 0
    for k in range(NUM_GAUSSIANS):
        g = channel + k * NUM_CHANNELS
        data[g] = s16(data[g] + offset)
        result = s32(result + data[g] * weights[g])
    return result


def gmm_probability(self: "WebRtcVadRef", features: list[int],
                    total_power: int, frame_length: int) -> int:
    """One frame's VAD decision + sequential model update (vad_core.c)."""
    vadflag = 0
    delta_n = [0] * TABLE_SIZE
    delta_s = [0] * TABLE_SIZE
    ngprvec = [0] * TABLE_SIZE     # conditional probability = 0
    sgprvec = [0] * TABLE_SIZE

    # Thresholds by frame length (80/160/240 samples at 8 kHz).
    fl_index = {80: 0, 160: 1, 240: 2}[frame_length]
    overhead1 = self.over_hang_max_1[fl_index]
    overhead2 = self.over_hang_max_2[fl_index]
    individual_test = self.individual[fl_index]
    total_test = self.total[fl_index]

    if total_power > MIN_ENERGY:
        # LRT with H0 = noise, H1 = speech: global weighted test + local
        # per-channel tests.
        sum_log_likelihood_ratios = 0
        noise_probability = [0, 0]
        speech_probability = [0, 0]
        for channel in range(NUM_CHANNELS):
            h0_test = 0
            h1_test = 0
            for k in range(NUM_GAUSSIANS):
                gaussian = channel + k * NUM_CHANNELS
                prob, delta_n[gaussian] = gaussian_probability(
                    features[channel], self.noise_means[gaussian],
                    self.noise_stds[gaussian])
                noise_probability[k] = s32(
                    NOISE_DATA_WEIGHTS[gaussian] * prob)
                h0_test = s32(h0_test + noise_probability[k])      # Q27
                prob, delta_s[gaussian] = gaussian_probability(
                    features[channel], self.speech_means[gaussian],
                    self.speech_stds[gaussian])
                speech_probability[k] = s32(
                    SPEECH_DATA_WEIGHTS[gaussian] * prob)
                h1_test = s32(h1_test + speech_probability[k])     # Q27

            # log2(Pr{X|H1}/Pr{X|H0}) ~= shifts_h0 - shifts_h1 (Q(-1)ish).
            shifts_h0 = 31 if h0_test == 0 else norm_w32(h0_test)
            shifts_h1 = 31 if h1_test == 0 else norm_w32(h1_test)
            log_likelihood_ratio = s16(shifts_h0 - shifts_h1)

            sum_log_likelihood_ratios = s32(
                sum_log_likelihood_ratios
                + log_likelihood_ratio * SPECTRUM_WEIGHT[channel])
            # Local VAD decision.
            if (log_likelihood_ratio * 4) > individual_test:
                vadflag = 1

            # Conditional probabilities used by the model update.
            h0 = s16(h0_test >> 12)                                # Q15
            if h0 > 0:
                tmp1_s32 = s32((noise_probability[0] & 0xFFFFF000) << 2)
                ngprvec[channel] = s16(div_w32_w16(tmp1_s32, h0))  # Q14
                ngprvec[channel + NUM_CHANNELS] = s16(
                    16384 - ngprvec[channel])
            else:
                ngprvec[channel] = 16384
            h1 = s16(h1_test >> 12)                                # Q15
            if h1 > 0:
                tmp1_s32 = s32((speech_probability[0] & 0xFFFFF000) << 2)
                sgprvec[channel] = s16(div_w32_w16(tmp1_s32, h1))  # Q14
                sgprvec[channel + NUM_CHANNELS] = s16(
                    16384 - sgprvec[channel])

        # Global VAD decision.
        if sum_log_likelihood_ratios >= total_test:
            vadflag |= 1

        # --- Sequential model update ---------------------------------
        maxspe = 12800
        for channel in range(NUM_CHANNELS):
            # Long-term minimum (Q4) for noise-mean correction.
            feature_minimum = find_minimum(self, features[channel], channel)

            noise_global_mean = weighted_average(
                self.noise_means, channel, 0, NOISE_DATA_WEIGHTS)
            tmp1_s16 = s16(noise_global_mean >> 6)                 # Q8

            for k in range(NUM_GAUSSIANS):
                gaussian = channel + k * NUM_CHANNELS
                nmk = self.noise_means[gaussian]
                smk = self.speech_means[gaussian]
                nsk = self.noise_stds[gaussian]
                ssk = self.speech_stds[gaussian]

                # Noise mean update when the frame is noise only.
                nmk2 = nmk
                if not vadflag:
                    delt = s16(s32(ngprvec[gaussian]
                                   * delta_n[gaussian]) >> 11)     # Q14
                    nmk2 = s16(nmk + (s16(s32(delt * NOISE_UPDATE_CONST)
                                          >> 22)))                 # Q7

                # Long-term correction of the noise mean.
                ndelt = s16((feature_minimum << 4) - tmp1_s16)     # Q8
                nmk3 = s16(nmk2 + s16(s32(ndelt * BACK_ETA) >> 9)) # Q7

                # Clamp the noise-mean drift.
                tmp_s16 = s16((k + 5) << 7)
                if nmk3 < tmp_s16:
                    nmk3 = tmp_s16
                tmp_s16 = s16((72 + k - channel) << 7)
                if nmk3 > tmp_s16:
                    nmk3 = tmp_s16
                self.noise_means[gaussian] = nmk3

                if vadflag:
                    # Speech mean update.
                    delt = s16(s32(sgprvec[gaussian]
                                   * delta_s[gaussian]) >> 11)     # Q14
                    tmp_s16 = s16(s32(delt * SPEECH_UPDATE_CONST)
                                  >> 21)                           # Q8
                    smk2 = s16(smk + ((tmp_s16 + 1) >> 1))         # Q7
                    maxmu = s16(maxspe + 640)
                    if smk2 > maxmu:
                        smk2 = maxmu
                    self.speech_means[gaussian] = smk2

                    # Speech std update: ssk += 0.025*(delta*(x-m) - 1)/ssk.
                    tmp_s16 = s16((smk + 4) >> 3)                  # Q4
                    tmp_s16 = s16(features[channel] - tmp_s16)     # Q4
                    tmp1_s32 = s32(delta_s[gaussian] * tmp_s16) >> 3  # Q12
                    tmp2_s32 = s32(tmp1_s32 - 4096)
                    tmp_s16 = sgprvec[gaussian] >> 2
                    tmp1_s32 = s32(tmp_s16 * tmp2_s32)             # Q24
                    tmp2_s32 = tmp1_s32 >> 4                       # Q20
                    if tmp2_s32 > 0:
                        tmp_s16 = s16(div_w32_w16(tmp2_s32, ssk * 10))
                    else:
                        tmp_s16 = s16(div_w32_w16(-tmp2_s32, ssk * 10))
                        tmp_s16 = s16(-tmp_s16)
                    tmp_s16 = s16(tmp_s16 + 128)                   # rounding
                    ssk = s16(ssk + (tmp_s16 >> 8))
                    if ssk < MIN_STD:
                        ssk = MIN_STD
                    self.speech_stds[gaussian] = ssk
                else:
                    # Noise std update: nsk += ~0.001*(delta*(x-m) - 1)/nsk.
                    tmp_s16 = s16(features[channel] - (nmk >> 3))  # Q4
                    tmp1_s32 = s32(delta_n[gaussian] * tmp_s16) >> 3  # Q12
                    tmp2_s32 = s32(tmp1_s32 - 4096)
                    tmp_s16 = (ngprvec[gaussian] + 2) >> 2
                    tmp2_s32 = s32(tmp_s16 * tmp2_s32)             # Q24
                    tmp1_s32 = tmp2_s32 >> 14                      # Q20
                    if tmp1_s32 > 0:
                        tmp_s16 = s16(div_w32_w16(tmp1_s32, nsk))
                    else:
                        tmp_s16 = s16(div_w32_w16(-tmp1_s32, nsk))
                        tmp_s16 = s16(-tmp_s16)
                    tmp_s16 = s16(tmp_s16 + 32)                    # rounding
                    nsk = s16(nsk + (tmp_s16 >> 6))
                    if nsk < MIN_STD:
                        nsk = MIN_STD
                    self.noise_stds[gaussian] = nsk

            # Separate the models if they are too close (Q14 global means).
            noise_global_mean = weighted_average(
                self.noise_means, channel, 0, NOISE_DATA_WEIGHTS)
            speech_global_mean = weighted_average(
                self.speech_means, channel, 0, SPEECH_DATA_WEIGHTS)
            diff = s16(s16(speech_global_mean >> 9)
                       - s16(noise_global_mean >> 9))
            if diff < MINIMUM_DIFFERENCE[channel]:
                tmp_s16 = s16(MINIMUM_DIFFERENCE[channel] - diff)
                # ~0.8 / ~0.2 of the shortfall in Q7.
                tmp1_s16 = s16(s32(13 * tmp_s16) >> 2)
                tmp2_s16 = s16(s32(3 * tmp_s16) >> 2)
                speech_global_mean = weighted_average(
                    self.speech_means, channel, tmp1_s16,
                    SPEECH_DATA_WEIGHTS)
                noise_global_mean = weighted_average(
                    self.noise_means, channel, -tmp2_s16,
                    NOISE_DATA_WEIGHTS)

            # Clamp the global means.
            maxspe = MAXIMUM_SPEECH[channel]
            tmp2_s16 = s16(speech_global_mean >> 7)
            if tmp2_s16 > maxspe:
                tmp2_s16 = s16(tmp2_s16 - maxspe)
                for k in range(NUM_GAUSSIANS):
                    g = channel + k * NUM_CHANNELS
                    self.speech_means[g] = s16(self.speech_means[g]
                                               - tmp2_s16)
            tmp2_s16 = s16(noise_global_mean >> 7)
            if tmp2_s16 > MAXIMUM_NOISE[channel]:
                tmp2_s16 = s16(tmp2_s16 - MAXIMUM_NOISE[channel])
                for k in range(NUM_GAUSSIANS):
                    g = channel + k * NUM_CHANNELS
                    self.noise_means[g] = s16(self.noise_means[g] - tmp2_s16)
        self.frame_counter += 1

    # Hangover smoothing.
    if not vadflag:
        if self.over_hang > 0:
            vadflag = 2 + self.over_hang
            self.over_hang -= 1
        self.num_of_speech = 0
    else:
        self.num_of_speech += 1
        if self.num_of_speech > MAX_SPEECH_FRAMES:
            self.num_of_speech = MAX_SPEECH_FRAMES
            self.over_hang = overhead2
        else:
            self.over_hang = overhead1
    return vadflag


# ---------------------------------------------------------------------------
# Public instance (webrtcvad.Vad-compatible surface)
# ---------------------------------------------------------------------------


class WebRtcVadRef:
    """Drop-in transcription of ``webrtcvad.Vad`` (8/16 kHz, 10/20/30 ms)."""

    def __init__(self, mode: int = 3):
        # WebRtcVad_InitCore
        self.vad = 1
        self.frame_counter = 0
        self.over_hang = 0
        self.num_of_speech = 0
        self.downsampling_filter_states = [0, 0]          # int32 (16->8 kHz)
        self.noise_means = list(NOISE_DATA_MEANS)
        self.speech_means = list(SPEECH_DATA_MEANS)
        self.noise_stds = list(NOISE_DATA_STDS)
        self.speech_stds = list(SPEECH_DATA_STDS)
        self.low_value_vector = [10000] * (16 * NUM_CHANNELS)
        self.index_vector = [100] * (16 * NUM_CHANNELS)
        self.upper_state = [0] * 5
        self.lower_state = [0] * 5
        self.hp_filter_state = [0] * 4
        self.mean_value = [1600] * NUM_CHANNELS
        self.set_mode(mode)

    def set_mode(self, mode: int) -> None:
        if mode not in (0, 1, 2, 3):
            raise ValueError(f"invalid aggressiveness mode: {mode}")
        self.over_hang_max_1 = list(OVER_HANG_MAX_1[mode])
        self.over_hang_max_2 = list(OVER_HANG_MAX_2[mode])
        self.individual = list(LOCAL_THRESHOLD[mode])
        self.total = list(GLOBAL_THRESHOLD[mode])

    def _calc_vad_8khz(self, frame: list[int]) -> int:
        features, total_power = calculate_features(self, frame)
        self.vad = gmm_probability(self, features, total_power, len(frame))
        return self.vad

    def is_speech(self, frame, sample_rate: int = 16000) -> bool:
        """``frame``: int16 samples (list/array/bytes) of 10/20/30 ms."""
        if isinstance(frame, (bytes, bytearray)):
            import array
            frame = array.array("h", bytes(frame)).tolist()
        else:
            frame = [int(v) for v in frame]
        n = len(frame)
        if sample_rate == 16000:
            if n not in (160, 320, 480):
                raise ValueError(f"invalid frame length {n} @ 16 kHz")
            nb = downsampling(frame, self.downsampling_filter_states)
            return self._calc_vad_8khz(nb) > 0
        if sample_rate == 8000:
            if n not in (80, 160, 240):
                raise ValueError(f"invalid frame length {n} @ 8 kHz")
            return self._calc_vad_8khz(frame) > 0
        raise ValueError(f"unsupported sample rate {sample_rate} "
                         "(reference uses 16 kHz only)")
