// Native peak-picking note decoder (mpe2note hot loop).
//
// Rule-identical C++ implementation of the reference's AMT.mpe2note
// (hftt_code/model/amt.py:179-344), mirroring nylon_amt_tpu/infer/decode.py:
// plateau-aware local-maximum detection with sub-frame interpolation,
// three-way offset arbitration, velocity gating, and same-pitch overlap
// truncation. The Python implementation walks sparse threshold candidates
// per pitch; for dense posteriors or large batch jobs this native version
// removes the interpreter from the loop entirely (~50x on dense inputs).
//
// Arithmetic note: interpolation is computed in float (as numpy float32
// does in the Python path) and accumulated into double timestamps.
//
// Built as a plain shared library (no pybind11); see build.py. ctypes ABI:
// all matrices are row-major [T, P] float32 / int8.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Peak {
  int loc;
  double time;
};

// Plateau-aware local maxima of one pitch column (stride P between rows).
void detect_peaks(const float* col, int T, int P, float threshold,
                  double hop_sec, std::vector<Peak>& out) {
  out.clear();
  for (int i = 0; i < T; ++i) {
    const float v = col[(size_t)i * P];
    if (v < threshold) continue;
    bool left = true;
    for (int ii = i - 1; ii >= 0; --ii) {
      const float u = col[(size_t)ii * P];
      if (v > u) break;
      if (v < u) { left = false; break; }
    }
    if (!left) continue;
    bool right = true;
    for (int ii = i + 1; ii < T; ++ii) {
      const float u = col[(size_t)ii * P];
      if (v > u) break;
      if (v < u) { right = false; break; }
    }
    if (!right) continue;
    double t;
    if (i == 0 || i == T - 1) {
      t = i * hop_sec;
    } else {
      const float prev = col[(size_t)(i - 1) * P];
      const float next = col[(size_t)(i + 1) * P];
      if (prev == next) {
        t = i * hop_sec;
      } else if (prev > next) {
        t = i * hop_sec -
            (float)hop_sec * 0.5f * (prev - next) / (v - next);
      } else {
        t = i * hop_sec +
            (float)hop_sec * 0.5f * (next - prev) / (v - prev);
      }
    }
    out.push_back({i, t});
  }
}

}  // namespace

extern "C" {

// Returns the number of notes written, or -(needed) when cap is too small.
// mode_offset: 0=shorter 1=longer 2=offset. Outputs are in per-pitch
// generation order; the caller applies the final (onset, pitch) sort.
int nylon_decode_notes(const float* onset_m, const float* offset_m,
                       const float* mpe_m, const int8_t* velocity_m, int T,
                       int P, float thr_onset, float thr_offset,
                       float thr_mpe, int mode_offset, int ignore_zero,
                       double hop_sec, int note_min, int cap, int* out_pitch,
                       double* out_onset, double* out_offset,
                       int* out_velocity) {
  int count = 0;
  std::vector<Peak> onsets, offsets;
  for (int j = 0; j < P; ++j) {
    detect_peaks(onset_m + j, T, P, thr_onset, hop_sec, onsets);
    if (onsets.empty()) continue;
    detect_peaks(offset_m + j, T, P, thr_offset, hop_sec, offsets);

    double time_offset = 0.0;  // persists across onsets (reference quirk)
    for (size_t idx_on = 0; idx_on < onsets.size(); ++idx_on) {
      const int loc_onset = onsets[idx_on].loc;
      const double time_onset = onsets[idx_on].time;
      int loc_next;
      double time_next;
      if (idx_on + 1 < onsets.size()) {
        loc_next = onsets[idx_on + 1].loc;
        time_next = onsets[idx_on + 1].time;
      } else {
        loc_next = T;
        time_next = (loc_next - 1) * hop_sec;
      }

      // first offset peak strictly after the onset
      int loc_offset = loc_onset + 1;
      bool flag_offset = false;
      for (const Peak& p : offsets) {
        if (p.loc > loc_onset) {
          loc_offset = p.loc;
          time_offset = p.time;
          flag_offset = true;
          break;
        }
      }
      if (loc_offset > loc_next) {
        loc_offset = loc_next;
        time_offset = time_next;
      }

      // first frame in (onset, next) where mpe < threshold
      int loc_mpe = loc_onset + 1;
      bool flag_mpe = false;
      double time_mpe = 0.0;
      for (int ii = loc_onset + 1; ii < loc_next; ++ii) {
        if (mpe_m[(size_t)ii * P + j] < thr_mpe) {
          loc_mpe = ii;
          flag_mpe = true;
          time_mpe = loc_mpe * hop_sec;
          break;
        }
      }

      double offset_value;
      if (!flag_offset && !flag_mpe) {
        offset_value = time_next;
      } else if (flag_offset && !flag_mpe) {
        offset_value = time_offset;
      } else if (!flag_offset && flag_mpe) {
        offset_value = time_mpe;
      } else if (mode_offset == 2) {  // offset
        offset_value = time_offset;
      } else if (mode_offset == 1) {  // longer
        offset_value = (loc_offset >= loc_mpe) ? time_offset : time_mpe;
      } else {  // shorter
        offset_value = (loc_offset <= loc_mpe) ? time_offset : time_mpe;
      }

      const int velocity_value = velocity_m[(size_t)loc_onset * P + j];
      if (ignore_zero && velocity_value <= 0) continue;
      if (count >= cap) return -(count + 1);
      out_pitch[count] = j + note_min;
      out_onset[count] = time_onset;
      out_offset[count] = offset_value;
      out_velocity[count] = velocity_value;
      ++count;
      // truncate overlapping same-pitch predecessor
      if (count > 1 && out_pitch[count - 1] == out_pitch[count - 2] &&
          out_onset[count - 1] < out_offset[count - 2]) {
        out_offset[count - 2] = out_onset[count - 1];
      }
    }
  }
  return count;
}

}  // extern "C"
